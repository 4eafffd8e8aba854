"""The benchmark of ``repro_torch`` (the PyTorch and CUDA port) on NVIDIA
H100 cards: ``python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.  See
``harness.py`` for how a cell's files are found by name."""
