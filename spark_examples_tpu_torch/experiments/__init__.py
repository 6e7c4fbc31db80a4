"""Hardware probes: the counterparts of the TPU microbenchmarks under the
repository's ``experiments/``, as hand-written CUDA kernels
(``csrc/probes.cu``); and the generation kernel against the designs it was
chosen over.

    python -m spark_examples_tpu_torch.experiments.probe_ops       # u32 op costs
    python -m spark_examples_tpu_torch.experiments.vmem_capacity   # shared-memory limit
    python -m spark_examples_tpu_torch.experiments.gen_variants    # gen_genotypes' alternatives
"""
