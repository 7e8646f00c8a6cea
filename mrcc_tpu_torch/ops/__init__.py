"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch twins.

``sort`` holds K1 (key argsort), ``conv`` K2 (self-keyed k3 conv), K3 (k2
down / up and k3-table convs over explicit maps) and their weight
gradients, ``conv_q8`` the int8 k3, k3-table and down / up convs, ``rank``
B8 (neighbour tables from sorted keys), ``nn`` B10 (ICP nearest
neighbours), ``norm`` the masked batch norm with its ReLU and residual add
(forward and backward; no TPU kernel's counterpart), ``k3_order`` each
level's schedule of the k3 convs' tile (no TPU kernel's counterpart);
``build`` compiles and loads them.
"""
