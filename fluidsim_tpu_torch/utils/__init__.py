"""Frame-loop helpers."""
