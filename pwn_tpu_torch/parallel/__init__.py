"""Multi-device synthesis geometry of the port."""
