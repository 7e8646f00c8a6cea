"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch twins.

``sort`` holds K1 (key argsort), ``conv`` K2 (self-keyed k3 conv) and K3
(k2 down / up conv over explicit maps); ``build`` compiles and loads them.
"""
