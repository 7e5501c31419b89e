"""The benchmark of kube_throttler_tpu_torch on a CUDA card: ``python3 -m
gpubench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
