"""The port's Aligner (mmseqs2_tpu_torch.align.aligner) against the JAX
package's Aligner on its CPU path: the same queries and candidate targets,
made from a numpy seed, must give equal AlnResult records field by field
(integers, and floats computed by the same copied Python)."""

import dataclasses

import numpy as np
import pytest
import torch

from mmseqs2_tpu_torch.align import aligner as taligner
from mmseqs2_tpu_torch.data.submat import get_submat as t_get_submat
from mmseqs2_tpu_torch.ops.evalue import EvalueComputation as TEvalue

GO, GE = 11, 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it badly."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_side():
    from mmseqs2_tpu.align import aligner as jaligner
    from mmseqs2_tpu.data.submat import get_submat
    from mmseqs2_tpu.ops.evalue import EvalueComputation
    return jaligner, get_submat, EvalueComputation


def make_jobs_data(seed=11, n_queries=8, n_targets=20):
    """Queries from the background; per query, targets that are mutated
    copies with indels (planted homologs), unrelated randoms and, for every
    other query, the query itself flagged as an identity hit."""
    rng = np.random.default_rng(seed)
    data = []
    key = 0
    for qi in range(n_queries):
        q = rng.integers(0, 20, size=int(rng.integers(40, 200)))
        keys, seqs, ident = [], [], []
        for ti in range(n_targets):
            if ti == 0 and qi % 2 == 0:
                t, isid = q.copy(), True
            elif ti < 8:
                t = q.copy()
                mut = rng.random(len(t)) < rng.uniform(0.1, 0.5)
                t[mut] = rng.integers(0, 20, size=int(mut.sum()))
                lo = int(rng.integers(0, len(t) // 4))
                hi = len(t) - int(rng.integers(0, len(t) // 4))
                cut = int(rng.integers(lo + 1, hi))
                ins = rng.integers(0, 20, size=int(rng.integers(0, 6)))
                t = np.concatenate([rng.integers(0, 20, size=5), t[lo:cut],
                                    ins, t[cut + int(rng.integers(0, 4)):hi]])
                isid = False
            else:
                t = rng.integers(0, 20, size=int(rng.integers(30, 250)))
                isid = False
            keys.append(key)
            key += 1
            seqs.append(t.astype(np.int64))
            ident.append(isid)
        data.append((q.astype(np.int64), keys, seqs, ident))
    return data


def _run(aligner_mod, submat, evaluer_cls, data, mode, cov_mode, cov_thr,
         eval_thr, corr, **kw):
    total = sum(len(s) for _, _, seqs, _ in data for s in seqs)
    ev = evaluer_cls(total, submat, GO, GE)
    al = aligner_mod.Aligner(submat, GO, GE, ev, corr_score_weight=corr,
                             **kw)
    jobs = []
    for q, keys, seqs, ident in data:
        ctx = al.init_query(q)
        jobs.append((ctx, keys, seqs, [len(s) for s in seqs], ident))
    return al, al.align_batch(jobs, mode, cov_mode, cov_thr, eval_thr)


@pytest.mark.parametrize("mode,cov_mode,cov_thr,eval_thr,corr", [
    (0, 0, 0.0, 1e-3, 0.0),
    (1, 0, 0.5, 10.0, 0.0),
    (2, 0, 0.0, 10.0, 0.0),
    (2, 1, 0.3, 1e-3, 0.0),
    (2, 0, 0.0, 10.0, 0.5),
])
def test_align_batch_matches_jax(mode, cov_mode, cov_thr, eval_thr, corr):
    jaligner, j_get_submat, JEvalue = _jax_side()
    data = make_jobs_data()
    tsub = t_get_submat("blosum62.out", 2.0, 0.0)
    jsub = j_get_submat("blosum62.out", 2.0, 0.0)
    _, got = _run(taligner, tsub, TEvalue, data, mode, cov_mode, cov_thr,
                  eval_thr, corr, device="cpu")
    _, want = _run(jaligner, jsub, JEvalue, data, mode, cov_mode, cov_thr,
                   eval_thr, corr)
    n_bt = 0
    for gq, wq in zip(got, want):
        assert len(gq) == len(wq)
        for g, w in zip(gq, wq):
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
            n_bt += bool(g.backtrace)
    if mode == 2:
        assert n_bt > 0      # the backtrace stage really ran


def test_query_setup_and_identity_match_jax():
    jaligner, j_get_submat, JEvalue = _jax_side()
    data = make_jobs_data(seed=3, n_queries=3, n_targets=2)
    tsub = t_get_submat("blosum62.out", 2.0, 0.0)
    jsub = j_get_submat("blosum62.out", 2.0, 0.0)
    ta = taligner.Aligner(tsub, GO, GE, TEvalue(10_000, tsub, GO, GE),
                          device="cpu")
    ja = jaligner.Aligner(jsub, GO, GE, JEvalue(10_000, jsub, GO, GE))
    for q, _, _, _ in data:
        tc, jc = ta.init_query(q), ja.init_query(q)
        np.testing.assert_array_equal(tc.profile, jc.profile)
        np.testing.assert_array_equal(tc.comp_bias_i8, jc.comp_bias_i8)
        assert tc.bias == jc.bias
        for mode in (0, 2):
            assert dataclasses.asdict(ta.score_identical(tc, q, mode)) == \
                dataclasses.asdict(ja.score_identical(jc, q, mode))
    with pytest.raises(NotImplementedError):
        ta.init_profile_query(None)
