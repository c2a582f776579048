"""Core numerics of the port: bit-planes, KV clustering, the compressed
store and controller (NumPy copies of the reference), and the Quest
precision ladder (torch)."""
