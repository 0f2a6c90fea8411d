"""The benchmark of raisr_tpu_torch on one NVIDIA card: `python3
gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
from the root of a checkout (see run.py)."""
