"""PyTorch + CUDA port of ``mrcc_tpu`` for one NVIDIA Hopper card.

Same data layout as the JAX package at every public function: ``[B, N, C]``
padded buffers with a validity mask, 30-bit packed int32 voxel keys with
``KEY_PAD = 2**30`` padding, ``K3_OFFSETS`` z-fastest with offset 13 the
identity, poses as ``[x, y, z, qw, qx, qy, qz]``.

Device rule: a CUDA tensor goes to the hand-written kernel (``csrc/``), a
CPU tensor to the kernel's plain PyTorch twin.  Nothing falls back.
"""
