"""Plain reference of one PCoA job, independent of the program under test.

It imports nothing of the program. Its inputs are the configuration and a
job's data seed, and it works everything out again from them:

- the synthetic cohort: a frozen copy of the generation rule (splitmix64
  site streams, the fmix32 genotype stream, Q32 allele-frequency
  thresholds over four contiguous populations), in plain int64 tensor
  arithmetic (u64 values held as the int64 with the same bits, products
  wrapping mod 2^64, logical shifts masked);
- the Gramian ``G = Xᵀ X`` of the has-variation rows, exact, in int32;
- the Gower centring in float64 and the top components of the centred
  matrix by float64 subspace iteration, run until its own residual is
  below ``REFERENCE_TOL``;
- the callset names the job must emit.

:func:`control_job` is the same pipeline one precision step down, put in
the program's place: centring in float32 and the eigensolve's products in
TF32 (float32 inputs rounded to a 10-bit mantissa, float32 sums), the step
that the program's explicit ``allow_tf32 = False`` guards against.

The judge and the control hold no (N, N) tensor but the int32 Gramian,
so a judge holds two (the program's and its own, 8 N² bytes) and scratch
of a few GiB: any cohort whose Gramian one card holds twice over can be
judged (:func:`gower_center`, whole, is the definition tests hold
:class:`Centred` to).
The Gramian is built a chunk of sites at a time (``SCRATCH_BYTES`` of
bfloat16 rows, each generated in sub-blocks of ``BLOCK_ELEMENTS``) and a
row block at a time (``SCRATCH_BYTES`` of float32 sums); the centred
matrix B is never formed: :class:`Centred` applies it to a few vectors
from float64 row blocks of ``SCRATCH_BYTES``, built from the int32 G
when they are needed.

The site streams do not depend on the contig's name, only on the position
``k · spacing``, so contigs that share grid indices share rows. The
reference generates each grid index once and weights its row by the
number of the job's contigs that hold it; the product is the same sum.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

MASK64 = (1 << 64) - 1
MASK32 = (1 << 32) - 1
_P1 = 0x9E3779B97F4A7C15
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0xD6E8FEB86659FD93
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
_S_REF_BLOCK = 1
_S_AF = 2
_S_POP_BASE = 3
_S_GENOTYPE = 100
_AF_BASE_Q32 = round(0.01 * 2**32)
_AF_SPAN_Q16 = round(0.49 * 2**16)
_POP_BASE_Q16 = round(0.25 * 2**16)
_POP_SPAN_Q17 = round(1.5 * 2**16)
_POP_LO_Q32 = round(0.002 * 2**32)
_POP_HI_Q32 = round(0.95 * 2**32)
_GOLD32 = 0x9E3779B9
_FMIX_C1 = 0x85EBCA6B
_FMIX_C2 = 0xC2B2AE35

#: The reference eigensolve's own residual, as a share of |λ₁|, below which
#: its components count as converged.
REFERENCE_TOL = 1e-11
#: Elements (sites × samples) of one generated sub-block: each int64
#: temporary of :meth:`Cohort.has_variation` is 512 MiB.
BLOCK_ELEMENTS = 1 << 26
#: Bytes of the largest scratch tensor of the blocked Gramian and centring:
#: a chunk of bfloat16 rows, a row block of float32 sums, of their int32
#: copy or of float64 B.
SCRATCH_BYTES = 1 << 30


def i64(value: int) -> int:
    """A u64 as the int64 with the same bits."""
    value &= MASK64
    return value - (1 << 64) if value >> 63 else value


def mix64_int(x: int) -> int:
    """splitmix64 finalizer on a Python int (mod 2^64)."""
    x = (x + _P1) & MASK64
    x = ((x ^ (x >> 30)) * _M1) & MASK64
    x = ((x ^ (x >> 27)) * _M2) & MASK64
    return x ^ (x >> 31)


def _srl(x: torch.Tensor, shift: int) -> torch.Tensor:
    return (x >> shift) & ((1 << (64 - shift)) - 1)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64-held u64 values."""
    x = x + i64(_P1)
    x = (x ^ _srl(x, 30)) * i64(_M1)
    x = (x ^ _srl(x, 27)) * i64(_M2)
    return x ^ _srl(x, 31)


def murmur3_h1(data: bytes) -> int:
    """The first 64-bit half of MurmurHash3 x64 128 (seed 0)."""
    c1, c2 = 0x87C37B91114253D5, 0x4CF5AD432745937F

    def rotl(x: int, r: int) -> int:
        return ((x << r) | (x >> (64 - r))) & MASK64

    def fmix(k: int) -> int:
        k ^= k >> 33
        k = (k * 0xFF51AFD7ED558CCD) & MASK64
        k ^= k >> 33
        k = (k * 0xC4CEB9FE1A85EC53) & MASK64
        return k ^ (k >> 33)

    h1 = h2 = 0
    n = len(data) // 16
    for i in range(n):
        k1 = int.from_bytes(data[16 * i : 16 * i + 8], "little")
        k2 = int.from_bytes(data[16 * i + 8 : 16 * i + 16], "little")
        h1 ^= (rotl((k1 * c1) & MASK64, 31) * c2) & MASK64
        h1 = (rotl(h1, 27) + h2) & MASK64
        h1 = (h1 * 5 + 0x52DCE729) & MASK64
        h2 ^= (rotl((k2 * c2) & MASK64, 33) * c1) & MASK64
        h2 = (rotl(h2, 31) + h1) & MASK64
        h2 = (h2 * 5 + 0x38495AB5) & MASK64
    tail = data[16 * n :]
    if len(tail) > 8:
        h2 ^= (rotl((int.from_bytes(tail[8:], "little") * c2) & MASK64, 33) * c1) & MASK64
    if tail:
        h1 ^= (rotl((int.from_bytes(tail[:8], "little") * c1) & MASK64, 31) * c2) & MASK64
    h1 ^= len(data)
    h2 ^= len(data)
    h1 = (h1 + h2) & MASK64
    h2 = (h2 + h1) & MASK64
    h1, h2 = fmix(h1), fmix(h2)
    return (h1 + h2) & MASK64


@dataclass(frozen=True)
class Cohort:
    """One job's synthetic cohort: the configuration's sizes and the job's
    data seed."""

    seed: int
    num_samples: int
    variant_set_id: str
    contigs: Tuple[Tuple[str, int, int], ...]
    spacing: int
    n_pops: int
    ref_block_fraction: float

    @classmethod
    def from_config(cls, config: Dict, seed: int) -> "Cohort":
        if config.get("min_allele_frequency") is not None:
            raise ValueError("the reference generates without an allele-frequency filter")
        return cls(
            seed=int(seed) & MASK64,
            num_samples=int(config["num_samples"]),
            variant_set_id=str(config["variant_set_id"]),
            contigs=tuple((str(c[0]), int(c[1]), int(c[2])) for c in config["contigs"]),
            spacing=int(config["variant_spacing"]),
            n_pops=int(config["n_pops"]),
            ref_block_fraction=float(config["ref_block_fraction"]),
        )

    @property
    def site_key(self) -> int:
        return mix64_int(self.seed)

    @property
    def vs_key(self) -> int:
        return mix64_int(self.seed ^ murmur3_h1(self.variant_set_id.encode("utf-8")))

    def grid_ranges(self) -> List[Tuple[int, int]]:
        """Each contig's grid indices ``[k0, k1)``: positions ``k · spacing``
        inside ``[start, end)``."""
        s = self.spacing
        out = []
        for _, start, end in self.contigs:
            k0 = -(-max(start, 0) // s)
            out.append((k0, max(k0, -(-end // s))))
        return out

    def grid_sites(self) -> int:
        """Candidate sites of the job: every contig's grid, summed."""
        return sum(k1 - k0 for k0, k1 in self.grid_ranges())

    def grid_weights(self, device) -> Tuple[int, torch.Tensor]:
        """``(first index, weights)``: how many of the job's contigs hold
        each grid index from the first on."""
        ranges = [r for r in self.grid_ranges() if r[1] > r[0]]
        lo = min(k0 for k0, _ in ranges)
        hi = max(k1 for _, k1 in ranges)
        diff = torch.zeros(hi - lo + 1, dtype=torch.int64)
        for k0, k1 in ranges:
            diff[k0 - lo] += 1
            diff[k1 - lo] -= 1
        return lo, torch.cumsum(diff, 0)[:-1].to(device)

    def names(self) -> List[str]:
        """Callset names, sample by sample: ``S<tag>N<index>``."""
        tag = self.vs_key % 90
        return [f"S{tag:02d}N{i:05d}" for i in range(self.num_samples)]

    def populations(self, device) -> torch.Tensor:
        n = self.num_samples
        return (torch.arange(n, dtype=torch.int64, device=device) * self.n_pops) // max(1, n)

    def _stream(self, key: int, pos_term: torch.Tensor, stream: int) -> torch.Tensor:
        h = mix64(pos_term ^ i64(key))
        h = mix64(h ^ i64(stream * _P3))
        return mix64(mix64(h))

    def thresholds(self, positions: torch.Tensor) -> torch.Tensor:
        """(B, n_pops) int64 Q32 genotype thresholds, 0 at dropped
        (reference-block) sites."""
        pos_term = positions * i64(_P2)
        key = self.site_key
        ref_thresh = math.ceil(self.ref_block_fraction * 2.0**53)
        is_ref = _srl(self._stream(key, pos_term, _S_REF_BLOCK), 11) < ref_thresh
        u_af = _srl(self._stream(key, pos_term, _S_AF), 48)
        af_q32 = _AF_BASE_Q32 + ((u_af * u_af * _AF_SPAN_Q16) >> 16)
        pops = []
        for p in range(self.n_pops):
            u_p = _srl(self._stream(key, pos_term, _S_POP_BASE + p), 48)
            factor = _POP_BASE_Q16 + ((u_p * _POP_SPAN_Q17) >> 16)
            pops.append(((af_q32 * factor) >> 16).clamp(_POP_LO_Q32, _POP_HI_Q32))
        table = torch.stack(pops, dim=1)
        return torch.where(is_ref[:, None], torch.zeros_like(table), table)

    def has_variation(self, positions: torch.Tensor, pops: torch.Tensor) -> torch.Tensor:
        """(B, N) bool: a sample carries an alternate allele at a site."""
        pos_term = positions * i64(_P2)
        h2 = mix64(mix64(pos_term ^ i64(self.vs_key)) ^ i64(_S_GENOTYPE * _P3))
        samples = torch.arange(self.num_samples, dtype=torch.int64, device=positions.device)
        x = h2[:, None] ^ (samples * i64(_P4))[None, :]
        x = (_srl(x, 32) ^ x) & MASK32
        x = ((x ^ (x >> 16)) * _FMIX_C1) & MASK32
        x = ((x ^ (x >> 13)) * _FMIX_C2) & MASK32
        d1 = x ^ (x >> 16)
        d2 = ((d1 * _GOLD32) & MASK32) ^ _FMIX_C1
        t = self.thresholds(positions)[:, pops]
        return (d1 < t) | (d2 < t)


def kept_sites(cohort: Cohort, device) -> int:
    """Sites the product needs: every contig's kept (not reference-block)
    grid sites."""
    lo, weights = cohort.grid_weights(device)
    total = torch.zeros((), dtype=torch.int64, device=device)
    step = 1 << 22
    for off in range(0, weights.numel(), step):
        w = weights[off : off + step]
        positions = torch.arange(lo + off, lo + off + w.numel(), dtype=torch.int64,
                                 device=device) * cohort.spacing
        kept = cohort.thresholds(positions)[:, 0] != 0
        total += (w * kept).sum()
    return int(total)


def _product(left: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``leftᵀ x`` of {0,1} rows (``left`` weighted), exact. On the card the
    operands are bfloat16 (0, 1 and the weights ≤ 256 are exact) with
    float32 sums, exact below 2^24; on the CPU float64."""
    if x.is_cuda:
        return torch.mm(left.T, x, out_dtype=torch.float32)
    return left.T @ x


def reference_gramian(cohort: Cohort, device) -> torch.Tensor:
    """The job's exact Gramian, int32 (N, N). Each chunk of grid sites is
    generated once, into ``SCRATCH_BYTES`` of rows, and its weighted
    product is added a row block of G at a time."""
    n = cohort.num_samples
    lo, weights = cohort.grid_weights(device)
    most = int(weights.max())
    if most > 256:
        raise ValueError("more than 256 contigs share a grid index")
    # The largest entry is on the diagonal, at most the weighted site count.
    if int(weights.sum()) >= 1 << 31:
        raise ValueError("the Gramian's entries may pass 2^31: int32 cannot hold them")
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float64
    # A chunk's float32 sums stay below ``most · chunk`` < 2^24.
    chunk = max(1, min(SCRATCH_BYTES // (2 * n), (1 << 24) // (most + 1)))
    sub = max(1, BLOCK_ELEMENTS // n)
    rows = max(1, SCRATCH_BYTES // (4 * n))
    pops = cohort.populations(device)
    G = torch.zeros((n, n), dtype=torch.int32, device=device)
    for off in range(0, weights.numel(), chunk):
        w = weights[off : off + chunk].to(dtype)
        X = torch.empty((w.numel(), n), dtype=dtype, device=device)
        for a in range(0, w.numel(), sub):
            b = min(a + sub, w.numel())
            positions = torch.arange(lo + off + a, lo + off + b, dtype=torch.int64,
                                     device=device) * cohort.spacing
            X[a:b] = cohort.has_variation(positions, pops)
        for r in range(0, n, rows):
            G[r : r + rows] += _product(X[:, r : r + rows] * w[:, None], X).to(torch.int32)
        del X
    return G


def gower_center(G: torch.Tensor) -> torch.Tensor:
    """``B = G − rowMean − colMean + matrixMean`` in float64, whole: the
    definition that :class:`Centred` applies a row block at a time."""
    S = G.to(torch.float64)
    return S - S.mean(dim=1, keepdim=True) - S.mean(dim=0, keepdim=True) + S.mean()


def _mean_of_total(total: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``total / n²`` rounded as torch's ``mean`` of an (n, n) tensor rounds
    it on this device: the mean of an (n, n) view whose one nonzero entry
    is ``total``, so that the sum is exact in any order."""
    w = torch.zeros(2 * n - 1, dtype=dtype, device=total.device)
    w[-1] = total.to(dtype)
    return w.as_strided((n, n), (1, 1)).mean()


class Centred:
    """``gower_center(G)`` as an operator on the symmetric int32 G: ``B @ V``
    from float64 row blocks of B, each built when it is needed and bit-equal
    to ``gower_center``'s rows while G's sums stay below 2^53.

    The row means are torch's float64 means of each row block (an integer
    sum is exact in any order, and each rounds once as the whole matrix's
    would); by symmetry they are the column means too; the matrix mean
    comes from the int64 total. Each block is ``G − rowMean − colMean +
    mean`` in that elementwise order.
    """

    dtype = torch.float64

    def __init__(self, G: torch.Tensor):
        n = int(G.shape[0])
        self.G = G
        self.shape = (n, n)
        self.device = G.device
        rows = max(1, SCRATCH_BYTES // (8 * n))
        self.spans = [(r, min(r + rows, n)) for r in range(0, n, rows)]
        self.row_mean = torch.cat([G[a:b].to(self.dtype).mean(dim=1) for a, b in self.spans])
        total = sum(G[a:b].sum(dtype=torch.int64) for a, b in self.spans)
        self.mean = _mean_of_total(total, n, self.dtype)

    def block(self, a: int, b: int) -> torch.Tensor:
        """Rows ``a:b`` of B."""
        S = self.G[a:b].to(self.dtype)
        S -= self.row_mean[a:b, None]
        S -= self.row_mean[None, :]
        S += self.mean
        return S

    def __matmul__(self, V: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.block(a, b) @ V for a, b in self.spans])


class ControlCentred(Centred):
    """The control's B: ``gower_center`` in float32 (row and column means
    float32 reductions apart), symmetrised as ``(B + Bᵀ) / 2``, applied with
    TF32 products."""

    dtype = torch.float32

    def __init__(self, G: torch.Tensor):
        super().__init__(G)
        self.col_mean = torch.cat([G[:, a:b].to(self.dtype).mean(dim=0) for a, b in self.spans])

    def block(self, a: int, b: int) -> torch.Tensor:
        S = self.G[a:b].to(self.dtype)
        B = S - self.row_mean[a:b, None] - self.col_mean[None, :] + self.mean
        # Bᵀ's rows a:b, with G symmetric.
        Bt = S - self.row_mean[None, :] - self.col_mean[a:b, None] + self.mean
        return (B + Bt) * 0.5

    def __matmul__(self, V: torch.Tensor) -> torch.Tensor:
        return torch.cat([tf32(self.block(a, b)) @ tf32(V) for a, b in self.spans])


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    away from zero), as the tensor cores read them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _subspace(B, num_pc: int, k: int, iterations: int, matmul):
    """Subspace iteration on B (a tensor or a :class:`Centred`); ``matmul``
    takes the (N, k) and (k, k) products."""
    generator = torch.Generator(device=B.device).manual_seed(0)
    V = torch.randn((B.shape[0], k), generator=generator, dtype=B.dtype, device=B.device)
    V, _ = torch.linalg.qr(V)
    for _ in range(iterations):
        V, _ = torch.linalg.qr(B @ V)
    W = B @ V
    T = matmul(V.T, W)
    evals, Wk = torch.linalg.eigh((T + T.T) * 0.5)
    order = torch.argsort(-evals.abs(), stable=True)[:num_pc]
    return matmul(V, Wk[:, order]), evals[order]


def top_components(B, num_pc: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's top-|λ| eigenpairs of B (a float64 tensor or a
    :class:`Centred`), iterated until each pair's residual is below
    ``REFERENCE_TOL · |λ₁|``."""
    k = min(B.shape[0], num_pc + 14)
    for iterations in (40, 120, 400):
        V, evals = _subspace(B, num_pc, k, iterations, torch.matmul)
        R = B @ V - V * evals[None, :]
        residual = float(R.norm(dim=0).max() / evals.abs().max())
        if residual < REFERENCE_TOL:
            return V, evals
    raise RuntimeError(f"the reference eigensolve did not converge: residual {residual:.3e}")


@dataclass
class JobOutput:
    """What one job hands back to be judged: its emitted rows and the
    Gramian its ingest produced."""

    lines: List[str]
    gramian: torch.Tensor


def format_rows(cohort: Cohort, components: torch.Tensor) -> List[str]:
    """Rows as the program emits them: ``name<TAB>dataset<TAB>pc...``,
    sorted by name."""
    values = components.double().cpu().tolist()
    rows = sorted(zip(cohort.names(), values))
    return ["\t".join([name, cohort.variant_set_id, *(str(v) for v in pcs)])
            for name, pcs in rows]


def control_job(cohort: Cohort, num_pc: int, device) -> JobOutput:
    """The reference one precision step down, in the program's place:
    centring in float32, the eigensolve's products in TF32, the program's
    iteration (80 steps of a ``num_pc + 8`` subspace)."""
    G = reference_gramian(cohort, device)
    k = min(cohort.num_samples, num_pc + 8)
    V, _ = _subspace(ControlCentred(G), num_pc, k, 80, lambda a, b: tf32(a) @ tf32(b))
    return JobOutput(format_rows(cohort, V), G)


__all__ = [
    "Centred",
    "Cohort",
    "ControlCentred",
    "JobOutput",
    "REFERENCE_TOL",
    "SCRATCH_BYTES",
    "control_job",
    "format_rows",
    "gower_center",
    "kept_sites",
    "reference_gramian",
    "tf32",
    "top_components",
]
