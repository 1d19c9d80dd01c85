"""Grid geometry and transfer splines."""
