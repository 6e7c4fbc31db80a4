"""The port's probes (``spark_examples_tpu_torch/experiments/``) against the
TPU kernels they replace, run through Pallas in interpret mode on the CPU.

The reference scripts run their loops at import, so each kernel is rebuilt
from the script's own source cut before its module-level loop:
``experiments/probe_ops.py`` up to ``for op in``, ``experiments/
vmem_capacity.py`` up to ``import sys`` (with a ``pl`` whose
``pallas_call`` adds ``interpret=True``)."""

import pathlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from spark_examples_tpu_torch.experiments import probe_ops, vmem_capacity

EXPERIMENTS = pathlib.Path(__file__).resolve().parents[1] / "experiments"


def _source_before(name, marker):
    text = (EXPERIMENTS / name).read_text()
    return text[: text.index(marker)]


@pytest.fixture(scope="module")
def reference_make():
    namespace = {}
    code = _source_before("probe_ops.py", "\nfor op in")
    exec(compile(code, "experiments/probe_ops.py", "exec"), namespace)
    assert namespace["R"] == probe_ops.R and tuple(namespace["SH"]) == probe_ops.SHAPE
    return namespace["make"]


@pytest.mark.parametrize("op", probe_ops.OPS)
def test_op_chain_matches_the_pallas_kernel_bit_for_bit(reference_make, op):
    x = probe_ops.random_tile(seed=11, shape=(8, 128))
    kernel = pl.pallas_call(
        reference_make(op),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.uint32),
        interpret=True,
    )
    want = np.asarray(kernel(jnp.asarray(x.view(np.uint32)))).view(np.int32)
    got = probe_ops.probe_op_chain(torch.from_numpy(x), op)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("length", [1, 3, 4097])
@pytest.mark.parametrize("op", probe_ops.OPS)
def test_op_chain_at_ragged_lengths_matches_the_pallas_kernel(reference_make, op, length):
    """Lengths that are not a whole number of the card kernel's 16-byte
    vectors, through the plain chain (a CPU tensor) and the Pallas body in
    interpret mode, and the same values on a view one element in."""
    base = probe_ops.random_tile(seed=length, shape=(1, length + 1))
    x = base[:, 1:]
    kernel = pl.pallas_call(
        reference_make(op),
        out_shape=jax.ShapeDtypeStruct((1, length), jnp.uint32),
        interpret=True,
    )
    want = np.asarray(kernel(jnp.asarray(np.ascontiguousarray(x).view(np.uint32)))).view(np.int32)
    view = torch.from_numpy(base).view(-1)[1:]
    got = probe_ops.probe_op_chain(view, op)
    np.testing.assert_array_equal(got.numpy(), want[0])


def test_run_chains_the_output_as_the_reference_does():
    x = torch.from_numpy(probe_ops.random_tile(seed=2, shape=(4, 64)))
    out, ms = probe_ops.run("fmix32", device="cpu", x=x, reps=3)
    want = x
    for _ in range(4):
        want = probe_ops.probe_op_chain_plain(want, "fmix32")
    assert ms is None and torch.equal(out, want)
    with pytest.raises(ValueError, match="unknown op"):
        probe_ops.probe_op_chain(x, "div")


def test_scratch_copy_matches_the_pallas_kernel():
    captured = []

    def pallas_call(kernel, **kwargs):
        call = pl.pallas_call(kernel, interpret=True, **kwargs)

        def run(*args):
            captured.append((args, call(*args)))
            return captured[-1][1]

        return run

    namespace = {"pl": types.SimpleNamespace(pallas_call=pallas_call, BlockSpec=pl.BlockSpec)}
    code = _source_before("vmem_capacity.py", "import sys").replace(
        "from jax.experimental import pallas as pl\n", ""
    )
    exec(compile(code, "experiments/vmem_capacity.py", "exec"), namespace)
    assert namespace["try_scratch"](1)
    (x,), want = captured[-1]
    got = vmem_capacity.scratch_copy(torch.from_numpy(np.array(x)), 1 << 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scratch_probe_on_the_cpu():
    """The plain copy at the bisection's ends and at an unaligned size; the
    probe's checks."""
    assert all(
        vmem_capacity.try_scratch(n, device="cpu")
        for n in (vmem_capacity.LOW, vmem_capacity.LOW + 5, vmem_capacity.HIGH)
    )
    limit, tried = vmem_capacity.find_limit(device="cpu")
    assert limit == vmem_capacity.HIGH and tried == [(vmem_capacity.LOW, True), (vmem_capacity.HIGH, True)]
    with pytest.raises(ValueError, match="tile"):
        vmem_capacity.scratch_copy(torch.zeros(vmem_capacity.TILE), 100)
    with pytest.raises(ValueError, match="CUDA card"):
        vmem_capacity.max_shared_memory_optin("cpu")
