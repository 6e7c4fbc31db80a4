"""Hardware probes: the counterparts of the TPU microbenchmarks under the
repository's ``experiments/``, as hand-written CUDA kernels
(``csrc/probes.cu``).

    python -m spark_examples_tpu_torch.experiments.probe_ops       # u32 op costs
    python -m spark_examples_tpu_torch.experiments.vmem_capacity   # shared-memory limit
"""
