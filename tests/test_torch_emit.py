"""The driver's rows and emitted TSV, built in bulk, against a plain per-row
version written here (a reverse index, a list per sample, a ``print`` per
line): the same rows, the same lines, the same standard output and the same
``--output-path`` file, byte for byte."""

import contextlib
import io
import os

import numpy as np
import pytest

from spark_examples_tpu_torch.config import PcaConf
from spark_examples_tpu_torch.pipeline.pca_driver import VariantsPcaDriver
from spark_examples_tpu_torch.sources.synthetic import SyntheticGenomicsSource


class _Callsets(SyntheticGenomicsSource):
    """A source whose callsets are given, in the given order."""

    def __init__(self, callsets):
        super().__init__(num_samples=1, seed=1)
        self._callsets = callsets

    def search_callsets(self, variant_set_ids):
        return list(self._callsets)


def _plain_rows(indexes, components):
    reverse = {i: cs_id for cs_id, i in indexes.items()}
    return [(reverse[i], [float(c) for c in components[i]]) for i in range(len(indexes))]


def _plain_emit(names, result, output_path):
    rows = []
    for callset_id, pcs in result:
        rows.append((names[callset_id], callset_id.split("-")[0], pcs))
    rows.sort(key=lambda r: r[0])
    lines = []
    for name, dataset, pcs in rows:
        pc_text = "\t".join(str(c) for c in pcs)
        lines.append(f"{name}\t{dataset}\t{pc_text}")
        print(lines[-1])
    if output_path:
        out_dir = output_path + "-pca.tsv"
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "part-00000"), "w") as f:
            for name, dataset, pcs in rows:
                pc_text = "\t".join(str(c) for c in pcs)
                f.write(f"{name}\t{pc_text}\t{dataset}\n")
    return lines


def _interleaved():
    # Two sets whose names alternate once sorted.
    return [{"id": f"vsa-{i}", "name": f"N{2 * i:03d}"} for i in range(5)] + [
        {"id": f"vsb-{i}", "name": f"N{2 * i + 1:03d}"} for i in range(4)
    ]


def _equal_names():
    # The same sample names in two sets: stable order keeps the first set first.
    return [{"id": f"{vs}-{i}", "name": f"NA{12878 + (i * 7) % 5}"}
            for vs in ("vsa", "vsb") for i in range(5)]


@pytest.mark.parametrize(
    "callsets, num_pc",
    [(_interleaved(), 3), (_equal_names(), 2), ([], 2)],
    ids=["interleaved-sets", "equal-names", "no-rows"],
)
def test_rows_and_emit_match_the_per_row_version(tmp_path, callsets, num_pc):
    conf = PcaConf.parse(["--device", "cpu", "--num-pc", str(num_pc),
                          "--output-path", str(tmp_path / "bulk")])
    with contextlib.redirect_stdout(io.StringIO()):
        driver = VariantsPcaDriver(conf, _Callsets(callsets), device="cpu")
    n = len(callsets)
    components = np.random.default_rng(n).standard_normal((n, num_pc))
    components[0::3] *= 1e-6  # exponent forms in str()
    rows = driver._component_rows(components)
    want_rows = _plain_rows(driver.indexes, components)
    assert rows == want_rows
    assert [type(r) for r in rows] == [tuple] * n

    got_out, want_out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(got_out):
        lines = driver.emit_result(rows)
    with contextlib.redirect_stdout(want_out):
        want_lines = _plain_emit(driver.names, want_rows, str(tmp_path / "plain"))
    assert lines == want_lines
    assert got_out.getvalue().encode() == want_out.getvalue().encode()
    part = os.path.join("{}-pca.tsv", "part-00000")
    with open(part.format(tmp_path / "bulk"), "rb") as got, \
            open(part.format(tmp_path / "plain"), "rb") as want:
        assert got.read() == want.read()
    if n:
        assert [line.split("\t")[0] for line in lines] == sorted(cs["name"] for cs in callsets)
    else:
        assert got_out.getvalue() == ""
