"""spark_examples_tpu_torch — the PyTorch/CUDA port of ``spark_examples_tpu``.

A second package beside the JAX one, which stays the reference. It runs the
flagship ``variants-pca`` pipeline on one NVIDIA Hopper card: the synthetic
1000 Genomes cohort is generated on the card and its Gramian accumulated by
hand-written CUDA kernels (``csrc/devicegen.cu``), then centered and
eigendecomposed with PyTorch. It imports neither JAX nor the JAX package.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``), where every kernel runs its plain
PyTorch version:

    from spark_examples_tpu_torch import run
    run(["--references", "17:41196311:41277499"])            # on the card
    run(["--num-samples", "16"], device="cpu")                # on the CPU
"""

__version__ = "0.1.0"

from spark_examples_tpu_torch.pipeline.pca_driver import run, run_pipeline  # noqa: E402

__all__ = ["__version__", "run", "run_pipeline"]
