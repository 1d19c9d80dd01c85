"""The FLIP frame and the simulation that steps it."""
