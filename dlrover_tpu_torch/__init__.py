"""PyTorch and CUDA port of ``dlrover_tpu`` for NVIDIA Hopper GPUs.

Each module mirrors the path and names of its ``dlrover_tpu`` counterpart
and says which it is. The port imports torch and numpy only: nothing of
JAX and nothing of ``dlrover_tpu``. Entry points run on the GPU unless the
caller passes ``device="cpu"``; with no GPU they raise.
"""
