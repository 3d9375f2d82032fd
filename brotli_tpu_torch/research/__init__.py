"""The port's research probes: counterparts of the JAX package's
research/ scripts that hold Pallas kernels, run on the card."""
