"""Record models: the variant half of ``spark_examples_tpu/models``, as a
JAX-free copy (the reads half waits for the analyses)."""

from spark_examples_tpu_torch.models.variant import Call, Variant, VariantKey, VariantsBuilder

__all__ = ["Call", "Variant", "VariantKey", "VariantsBuilder"]
