"""Evaluation of the port: the receding-horizon replanning protocol."""
