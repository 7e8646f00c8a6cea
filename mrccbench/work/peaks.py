"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit; a card set lower runs
slower under load, so every run prints its card's limit beside them).

Float32 products of the port run on the tensor cores (a 3xTF32 split), so
their peak is the TF32 tensor-core rate, not the 67 TFLOP/s of the f32
units: a share of that lower peak could pass 100 % after an honest
speed-up.
"""

FLOPS = {"float32": 495e12, "bfloat16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}
SOURCE = "NVIDIA H100 SXM data sheet, dense, 700 W"
