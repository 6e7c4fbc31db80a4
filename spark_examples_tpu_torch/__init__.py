"""spark_examples_tpu_torch — the PyTorch/CUDA port of ``spark_examples_tpu``.

A second package beside the JAX one, which stays the reference. It runs the
flagship ``variants-pca`` pipeline on one NVIDIA Hopper card: the synthetic
1000 Genomes cohort is generated on the card (``csrc/devicegen.cu``), or
the synthetic cohort or VCF/JSONL files are fed from the host as packed
blocks or wire records (``csrc/gramian.cu`` unpacks them), the Gramian
accumulated by hand-written CUDA kernels, then centered and
eigendecomposed with PyTorch; ``api.py`` exposes the stages. The
``grm``, ``ld-prune`` and ``assoc-scan`` analyses (``analyses/``) run on
the same kernels and on ``csrc/ld.cu``. The reference's other examples
run too: ``search-variants-klotho`` and ``search-variants-brca1`` on the
host, ``search-reads-example-1`` … ``-4`` over reads from the synthetic
source, REST or SAM files, their depth and base counts on
``csrc/depth.cu``. The verbs not ported yet are ``graftcheck``,
``serve``, ``submit``, ``trace`` and ``obs``.
It imports neither JAX nor the JAX package.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``), where every kernel runs its plain
PyTorch version:

    from spark_examples_tpu_torch import run
    run(["--references", "17:41196311:41277499"])            # on the card
    run(["--num-samples", "16"], device="cpu")                # on the CPU
"""

__version__ = "0.1.0"

from spark_examples_tpu_torch.models.read import Read, ReadBuilder, ReadKey  # noqa: E402
from spark_examples_tpu_torch.models.variant import (  # noqa: E402
    Call,
    Variant,
    VariantKey,
    VariantsBuilder,
)
from spark_examples_tpu_torch.pipeline.pca_driver import (  # noqa: E402
    PipelineResult,
    run,
    run_pipeline,
)
from spark_examples_tpu_torch.sharding.contig import Contig, SexChromosomeFilter  # noqa: E402
from spark_examples_tpu_torch.sharding.partitioners import (  # noqa: E402
    FixedSplits,
    ReadsPartitioner,
    TargetSizeSplits,
    VariantsPartitioner,
)

__all__ = [
    "Call",
    "Contig",
    "FixedSplits",
    "PipelineResult",
    "Read",
    "ReadBuilder",
    "ReadKey",
    "ReadsPartitioner",
    "SexChromosomeFilter",
    "TargetSizeSplits",
    "Variant",
    "VariantKey",
    "VariantsBuilder",
    "VariantsPartitioner",
    "__version__",
    "run",
    "run_pipeline",
]
