"""Gapped/gapless alignment statistics (Karlin-Altschul / ALP Gumbel).

Reproduces the reference EvalueComputation exactly for the precomputed
parameter sets (reference src/alignment/EvalueComputation.h:47-90) and the
ALP finite-size-correction "area" formula
(reference lib/alp/sls_pvalues.cpp:366-480, sls_alignment_evaluer.cpp:989):

  area(y, qLen, dbResCount):
    m = dbResCount, n = qLen (note the swap in AlignmentEvaluer::area)
    m_li = m - (a_I*y + b_I);  vi = max(vi_thr, alpha_I*y + beta_I)
    mF = m_li / sqrt(vi);      p1 = m_li*Phi(mF) + sqrt(vi)*phi(mF)
    n_lj = n - (a_J*y + b_J);  vj = max(vj_thr, alpha_J*y + beta_J)
    nF = n_lj / sqrt(vj);      p2 = n_lj*Phi(nF) + sqrt(vj)*phi(nF)
    c  = max(c_thr, sigma*y + tau)
    area = p1*p2 + c*Phi(mF)*Phi(nF)
  with thresholds *_thr = max(2*alpha/lambda, 0) etc.
  (nat_cut_off_in_max = 2.0, lib/alp/sls_pvalues.cpp:46,352-354)

  evalue(score, qLen) = area * K * exp(-lambda*score)
  bitScore(score) = (lambda*score - log K) / log 2
"""

import math
from dataclasses import dataclass

NAT_CUTOFF = 2.0
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _phi_cdf(x: float) -> float:
    # reference sls_basic.hpp:195: 0.5*erfc(-sqrt(0.5)*x)
    return 0.5 * math.erfc(-math.sqrt(0.5) * x)


@dataclass(frozen=True)
class GumbelParams:
    lambda_: float
    K: float
    a1: float   # d_a1 -> a_J
    b1: float
    a2: float   # d_a2 -> a_I
    b2: float
    alpha1: float
    beta1: float
    alpha2: float
    beta2: float
    sigma: float
    tau: float


# Precomputed parameter sets (reference EvalueComputation.h:56-83).
# Key: (matrix_name, gap_open, gap_extend, is_gapped)
PRECOMPUTED = {
    ("nucleotide.out", 7, 1, True): GumbelParams(
        1.0960171987681839, 0.33538787507026158,
        2.0290734315292083, -0.46514786408422282,
        2.0290734315292083, -0.46514786408422282,
        5.0543294182155085, 15.130999712620039,
        5.0543294182155085, 15.130999712620039,
        5.0543962679167036, 15.129930117400917),
    ("nucleotide.out", 5, 2, True): GumbelParams(
        0.62092274139392822363, 0.35177597988201619872,
        0.74528059208662511548, -0.71027220445456995535,
        0.74528059208662511548, -0.71027220445456995535,
        1.0135243407674570104, -2.5226486486783059604,
        1.0135243407674570104, -2.5226486486783059604,
        1.0031949332622873694, -2.3780369436059309862),
    ("blosum62.out", 11, 1, True): GumbelParams(
        0.27359865037097330642, 0.044620920658722244834,
        1.5938724404943873658, -19.959867650284412122,
        1.5938724404943873658, -19.959867650284412122,
        30.455610143099914211, -622.28684628915891608,
        30.455610143099914211, -622.28684628915891608,
        29.602444874818868215, -601.81087985041381216),
    ("blosum62.out", 0, 0, False): GumbelParams(
        0.3207378152604042354, 0.13904657125294345166,
        0.76221128839920349041, 0,
        0.76221128839920349041, 0,
        4.5269915477182944841, 0,
        4.5269915477182944841, 0,
        4.5269915477182944841, 0),
}


def _alp_live(submat, gap_open, gap_extend, is_gapped):
    """Exact Gumbel parameters for an arbitrary matrix via the reference's
    ALP Monte-Carlo estimation (lib/alp, seed 42 — the simulation
    EvalueComputation::init runs at first use for unknown combos,
    reference src/alignment/EvalueComputation.h:108-132).

    The native helper native/alp_harvest.cpp is compiled once against the
    ALP library sources (env MMSEQS2_TPU_ALP_SRC) and results are cached
    in the package's build directory keyed by the matrix content + gap
    costs. Returns None when the ALP sources are unavailable."""
    import glob
    import hashlib
    import json
    import os
    import subprocess

    import numpy as np

    from .. import BUILD_DIR
    cache_root = BUILD_DIR
    alpha = submat.alphabet_size
    mat = submat.sub_matrix[:alpha, :alpha].astype(np.int64)
    pback = np.asarray(submat.pback, np.float64)
    h = hashlib.sha256()
    h.update(mat.tobytes())
    h.update(pback.tobytes())
    key = f"{h.hexdigest()[:20]}_{gap_open}_{gap_extend}_{int(is_gapped)}"
    cache_file = cache_root / "alp_live.json"
    try:
        cache = json.loads(cache_file.read_text())
    except (OSError, ValueError):
        cache = {}
    if key in cache:
        return GumbelParams(*cache[key])

    from .. import REPO_ROOT
    src = os.environ.get("MMSEQS2_TPU_ALP_SRC", "")
    cpp = REPO_ROOT / "native" / "alp_harvest.cpp"
    if not (src and os.path.isdir(src) and cpp.exists()):
        return None
    binp = cache_root / "alp_harvest"
    if not binp.exists():
        cache_root.mkdir(parents=True, exist_ok=True)
        srcs = sorted(glob.glob(os.path.join(src, "*.cpp")))
        r = subprocess.run(
            ["g++", "-O2", f"-I{src}", str(cpp), *srcs, "-o", str(binp)],
            capture_output=True)
        if r.returncode != 0:
            return None
    lines = [str(alpha)]
    for row in mat:
        lines.append(" ".join(str(int(x)) for x in row))
    lines.append(" ".join(repr(float(x)) for x in pback))
    lines.append(f"{gap_open} {gap_extend} {int(is_gapped)}")
    try:
        proc = subprocess.run([str(binp)], input="\n".join(lines) + "\n",
                              capture_output=True, text=True, timeout=240)
    except (subprocess.TimeoutExpired, OSError):
        return None
    for line in proc.stdout.splitlines():
        parts = line.split()
        if parts and parts[0] == "OK":
            par = [float(x) for x in parts[4:16]]
            cache[key] = par
            try:
                cache_root.mkdir(parents=True, exist_ok=True)
                cache_file.write_text(json.dumps(cache))
            except OSError:
                pass
            return GumbelParams(*par)
    return None


class EvalueComputation:
    """Drop-in equivalent of the reference EvalueComputation."""

    def __init__(self, db_res_count: int, submat, gap_open: int = 0,
                 gap_extend: int = 0, is_gapped: bool = None):
        if is_gapped is None:
            is_gapped = gap_open != 0 or gap_extend != 0
        self.db_res_count = float(db_res_count)
        key = (submat.name, gap_open, gap_extend, is_gapped)
        par = PRECOMPUTED.get(key)
        if par is None:
            from ..data.alp_params import ALP_PARAMS
            raw = ALP_PARAMS.get(key)
            if raw is not None:
                # [lambda, K, a_J, b_J, a_I, b_I, alpha_J, beta_J,
                #  alpha_I, beta_I, sigma, tau] -> GumbelParams field order
                par = GumbelParams(raw[0], raw[1], raw[2], raw[3], raw[4],
                                   raw[5], raw[6], raw[7], raw[8], raw[9],
                                   raw[10], raw[11])
        if par is None:
            # custom matrix: run the reference's ALP simulation via the
            # compile-once native helper (exact Gumbel params, disk-cached)
            par = _alp_live(submat, gap_open, gap_extend, is_gapped)
        if par is None:
            import warnings
            warnings.warn(
                f"no precomputed ALP Gumbel parameters for {key} and the "
                "ALP library sources are unavailable (set "
                "MMSEQS2_TPU_ALP_SRC to an ALP checkout for exact values); "
                "falling back to gapless Karlin-Altschul statistics — "
                "E-values will be approximate",
                stacklevel=2)
            par = self._simulate(submat, gap_open, gap_extend, is_gapped)
        # initParameters mapping (lib/alp/sls_alignment_evaluer.cpp:657-790):
        # a_I = d_a2, a_J = d_a1, etc.
        self.lambda_ = par.lambda_
        self.K = par.K
        self.logK = math.log(par.K)
        self.a_I, self.b_I = par.a2, par.b2
        self.a_J, self.b_J = par.a1, par.b1
        self.alpha_I, self.beta_I = par.alpha2, par.beta2
        self.alpha_J, self.beta_J = par.alpha1, par.beta1
        self.sigma, self.tau = par.sigma, par.tau
        self.vi_thr = max(NAT_CUTOFF * self.alpha_I / self.lambda_, 0.0)
        self.vj_thr = max(NAT_CUTOFF * self.alpha_J / self.lambda_, 0.0)
        self.c_thr = max(NAT_CUTOFF * self.sigma / self.lambda_, 0.0)

    @staticmethod
    def _simulate(submat, gap_open, gap_extend, is_gapped):
        if is_gapped:
            # ALP gapped simulation not (yet) ported; fall back to the gapless
            # island statistics of the matrix, a conservative approximation.
            # TODO(parity): port ALP's importance-sampling simulation.
            pass
        from .karlin import gapless_params

        lam, K, H = gapless_params(submat)
        a = 1.0 / H if H > 0 else 0.0
        alpha = lam / H if H > 0 else 0.0
        return GumbelParams(lam, K, a, 0.0, a, 0.0, alpha, 0.0, alpha, 0.0,
                            alpha, 0.0)

    # -- core formulas (exact reference parity) --------------------------------

    def area(self, score: float, seq_len: float) -> float:
        # AlignmentEvaluer::area(score, seqlen1=qLen, seqlen2=dbResCount)
        # calls get_appr_tail_prob(m_=seqlen2, n_=seqlen1)
        y = score
        m = self.db_res_count
        n = seq_len
        m_li = m - (self.a_I * y + self.b_I)
        vi = max(self.vi_thr, self.alpha_I * y + self.beta_I)
        sqrt_vi = math.sqrt(vi)
        mF = m_li / sqrt_vi if sqrt_vi != 0.0 else 1e100
        P_mF = _phi_cdf(mF)
        E_mF = -_INV_SQRT_2PI * math.exp(-0.5 * mF * mF)
        p1 = m_li * P_mF - sqrt_vi * E_mF

        n_lj = n - (self.a_J * y + self.b_J)
        vj = max(self.vj_thr, self.alpha_J * y + self.beta_J)
        sqrt_vj = math.sqrt(vj)
        nF = n_lj / sqrt_vj if sqrt_vj != 0.0 else 1e100
        P_nF = _phi_cdf(nF)
        E_nF = -_INV_SQRT_2PI * math.exp(-0.5 * nF * nF)
        p2 = n_lj * P_nF - sqrt_vj * E_nF

        c = max(self.c_thr, self.sigma * y + self.tau)
        return p1 * p2 + c * P_mF * P_nF

    def evalue_per_area(self, score: float) -> float:
        # C exp() overflows to +inf for very negative scores (glibc
        # HUGE_VAL); the reference then prints "INF" via %.3E
        try:
            return self.K * math.exp(-self.lambda_ * score)
        except OverflowError:
            return math.inf

    def compute_evalue(self, score: float, seq_len: float) -> float:
        return self.evalue_per_area(score) * self.area(score, seq_len)

    def compute_log_evalue(self, score: float, seq_len: float) -> float:
        return math.log(max(self.compute_evalue(score, seq_len), 5e-324))

    def compute_bit_score(self, score: float) -> float:
        return (self.lambda_ * score - self.logK) / math.log(2.0)

    def compute_raw_score_from_bit_score(self, bit_score: float) -> float:
        return (self.logK + bit_score * math.log(2.0)) / self.lambda_

    def min_score(self, evalue: float, q_len: float) -> int:
        s = (math.log(self.K * self.area(60, q_len)) - math.log(evalue)) / self.lambda_
        return int(math.ceil(max(1.0, s)))
