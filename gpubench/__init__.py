"""The benchmark of the PyTorch port (``spark_examples_tpu_torch``): a
harness driven by ``BENCHMARK.json``, its plain reference, and its tests.
It imports neither JAX nor the JAX package."""
