"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch twins.

``sort`` holds K1 (key argsort), ``conv`` K2 (self-keyed k3 conv), K3 (k2
down / up conv over explicit maps) and their weight gradients, ``conv_q8``
the int8 k3 and down / up convs; ``build`` compiles and loads them.
"""
