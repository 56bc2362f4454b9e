"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Every wrapper here takes its plain version only for CPU tensors; for CUDA
tensors it launches its kernel or raises. Each keeps a launch count in a plain
integer attribute (``wrapper.launches``), added to under a lock
(``_build.count_launch``): several threads launch at once when serving.
"""

KERNEL_SOURCES = ("flash_attention", "conv_pos", "flash_attention_train", "decode_attention",
                  "quant_matmul", "ablate_attention", "row_norm")  # csrc/<name>.cu
