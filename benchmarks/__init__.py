"""The benchmark of the PyTorch/CUDA port (``situation3d_tpu_torch``) on
NVIDIA H100 cards: ``python3 -m benchmarks.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. See README.md."""
