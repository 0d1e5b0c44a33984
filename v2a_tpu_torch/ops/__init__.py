"""Diffusion math and the hand-written kernels' wrappers."""
