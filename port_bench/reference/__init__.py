"""The plain float32 reference that decides `correct`: the video model's
networks (`nets`), its sampler, loss and optimizer (`diffusion`). It
imports nothing of the port, of the JAX package or of JAX."""
