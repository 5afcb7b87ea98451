"""The benchmark of videocad_tpu_torch on NVIDIA GPUs: one command runs one
cell of ``BENCHMARK.json`` once (``python3 benchmark/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``)."""
