"""Utilities of the port: profiling and reporting (`profiling.py`)."""
