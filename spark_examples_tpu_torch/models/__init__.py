"""Record models: the port's copies of ``spark_examples_tpu/models``
(variants and reads)."""

from spark_examples_tpu_torch.models.read import Read, ReadBuilder, ReadKey
from spark_examples_tpu_torch.models.variant import Call, Variant, VariantKey, VariantsBuilder

__all__ = ["Call", "Read", "ReadBuilder", "ReadKey", "Variant", "VariantKey", "VariantsBuilder"]
