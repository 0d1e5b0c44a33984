"""The port's networks and the serving entry points."""
