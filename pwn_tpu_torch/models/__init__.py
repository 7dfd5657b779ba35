"""Models of the port: the student IAF and its building blocks."""
