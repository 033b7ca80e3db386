#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mmseqs2_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Every phase raises on failure; nothing is
caught. Phases, each printing lines before the last:
  1. card: name and power limit (nvidia-smi);
  2. build: compile the port's CUDA kernel from csrc/sw.cu;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the align stage's shapes, exact integer equality required; times from
     CUDA events (median), GCUPS over the cells the inputs need, and the
     card's bound for those cells;
  4. golden parity: the port's `align` on the 500-query toy set equals the
     reference MMseqs2 goldens (tests/golden/toy, tests/golden/alt): default
     and non-default scoring, --realign, --alt-ali, --corr-score-weight;
  5. real size: `createdb` + `align -a` on 20,000 SwissProt-like targets and
     1,000 queries with 300 prefilter candidates each (300,000 pairs), data
     made from a seed; launch counts taken over this run; the first 32
     queries' results equal a run with the CPU requested (plain versions);
     then the same align once more under torch.profiler: the card's busy
     and idle shares, device time by kernel, tracing overhead;
  6. one JSON line listing every kernel;
and as the last line {"ok": true, "device": {...}}. Exits non-zero without a
CUDA card or outside a checkout of the repository.
"""

import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "toy"
WORK = ROOT / ".smoke_work"
SEED = 20261016

# H100 SXM, published: 3.35 TB/s HBM3; int32 rate of the CUDA cores:
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7 Top/s (the fp32 row of
# the data sheet, 67 TFLOP/s, is 132 x 128 lanes x 2 (FMA) x 1.98 GHz)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 instructions one affine-gap SW cell needs at the least, in Hopper's
# DPX forms (csrc/sw.cu lists them): H - go 1 (shared by E and F), E and F
# one __viaddmax_s32 each, max(diag + s, E) one __viaddmax_s32,
# max(., F, 0) one __vimax_s32_relu, running best 1. The data sheet gives no
# DPX rate; the bound takes one DPX instruction per int32 lane and clock.
SW_OPS_PER_CELL = 6


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi reported no card")
    return out[0].strip()


def time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def sw_bound_ms(nq, lq, lt, lanes, cells):
    """Least time of one sw_multi launch: the `cells` its inputs need at
    SW_OPS_PER_CELL int32 operations each, or its bytes (each input read
    once, each output written once), whichever takes longer."""
    ops_s = cells * SW_OPS_PER_CELL / INT32_OPS_PER_S
    nbytes = nq * 32 * lq * 4 + lt * lanes + 2 * 4 * lanes + 3 * 4 * lanes
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


# -- data from the seed --------------------------------------------------------

AA = "ARNDCQEGHILKMFPSTWYV"
# blosum62 background (ARNDCQEGHILKMFPSTWYV), as experiments/make_scale_db.py
PBACK = np.array([0.0789, 0.0540, 0.0448, 0.0536, 0.0125, 0.0402, 0.0669,
                  0.0716, 0.0219, 0.0566, 0.0977, 0.0594, 0.0239, 0.0396,
                  0.0484, 0.0684, 0.0541, 0.0113, 0.0306, 0.0656])
PBACK = PBACK / PBACK.sum()


def sw_case(rng, submat, nq, lq, lt, lanes, reverse, negative=False,
            big=False):
    """Inputs of one sw_multi launch as the align stage builds them: nq
    query profiles of the Lq bucket, lanes targets of the Lt bucket (half of
    them mutated fragments of their query), pad letter 31. The reverse pass
    takes the reversed profile (pad rows first) and qoff = lq - 1 - qend.
    Also returns the cells the launch needs: per lane, its real query rows
    at or past qoff times its real target length (pad rows and columns
    cannot raise the best score)."""
    from mmseqs2_tpu_torch.ops.encode import make_query_profile
    mat = submat.sub_matrix.astype(np.int32)
    aa_idx = np.array([submat.aa2num[c] for c in AA])
    profs, qseqs = [], []
    for _ in range(nq):
        n = int(rng.integers(lq // 2 + 1, lq + 1))
        q = aa_idx[rng.choice(20, size=n, p=PBACK)]
        prof = make_query_profile(q, mat, None, pad_len=lq, alpha_pad=32)
        if negative:
            prof = np.where(prof > -(1 << 20), -1 - np.abs(prof) % 7, prof)
        if big:
            prof[q[0], 0] = 255
        profs.append(prof[:, ::-1] if reverse else prof)
        qseqs.append(q)
    qsel = rng.integers(0, nq, size=lanes).astype(np.int32)
    tb = np.full((lt, lanes), 31, np.int8)
    tlen = np.zeros(lanes, np.int64)
    for b in range(lanes):
        n = int(rng.integers(lt // 2 + 1, lt + 1))
        t = aa_idx[rng.choice(20, size=n, p=PBACK)]
        if b % 2 == 0:
            q = qseqs[qsel[b]]
            m = min(len(q), n)
            frag = q[:m].copy()
            mut = rng.random(m) < 0.3
            frag[mut] = aa_idx[rng.choice(20, size=int(mut.sum()), p=PBACK)]
            t[:m] = frag[::-1] if reverse else frag
        tb[:n, b] = t
        tlen[b] = n
    qlen = np.array([len(q) for q in qseqs], np.int64)[qsel]
    if reverse:
        qend = (rng.random(lanes) * qlen).astype(np.int64)
        qoff = (lq - 1 - qend).astype(np.int32)
        rows = qend + 1
    else:
        qoff = np.zeros(lanes, np.int32)
        rows = qlen
    cells = int((rows * tlen).sum())
    return np.concatenate(profs), tb, qsel, qoff, cells


def phase_kernels(rng):
    import torch
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.ops import sw
    submat = get_submat("blosum62.out", 2.0, 0.0)
    cases = []
    for lq in (256, 512, 1024):
        for lt in (256, 512, 1024):
            for rev in (False, True):
                cases.append(dict(nq=16, lq=lq, lt=lt, lanes=4096,
                                  reverse=rev, go=11, ge=1))
    cases += [
        dict(nq=16, lq=512, lt=512, lanes=4096, reverse=False, go=13, ge=2),
        dict(nq=16, lq=512, lt=512, lanes=4096, reverse=True, go=13, ge=2),
        dict(nq=1, lq=4096, lt=1024, lanes=512, reverse=False, go=11, ge=1),
        dict(nq=1, lq=4096, lt=1024, lanes=512, reverse=True, go=11, ge=1),
        dict(nq=16, lq=512, lt=512, lanes=4096, reverse=False, go=11, ge=1,
             negative=True),
        dict(nq=16, lq=1024, lt=512, lanes=4096, reverse=False, go=11, ge=1,
             big=True),
    ]
    log("kernels vs plain versions: tolerance 0 (integer outputs, exact "
        "equality); ms = median of CUDA-event timings")
    rows = []
    for c in cases:
        pf, tb, qsel, qoff, cells = sw_case(
            rng, submat, c["nq"], c["lq"], c["lt"], c["lanes"], c["reverse"],
            c.get("negative", False), c.get("big", False))
        args = [torch.from_numpy(a).cuda() for a in (pf, tb, qsel, qoff)]
        go, ge = c["go"], c["ge"]
        got = sw.sw_multi(*args, go=go, ge=ge)
        want = sw.sw_multi_plain(*args, go=go, ge=ge)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in
                  zip(got, want))
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        if c.get("negative"):
            equal = equal and bool((got[0] == 0).all()) and bool(
                (got[2] == -1).all()) and bool((got[1] == c["lq"] - 1).all())
        ms = time_ms(lambda: sw.sw_multi(*args, go=go, ge=ge), 5)
        plain_ms = time_ms(lambda: sw.sw_multi_plain(*args, go=go, ge=ge), 2)
        bound, by = sw_bound_ms(c["nq"], c["lq"], c["lt"], c["lanes"], cells)
        padded = c["lanes"] * c["lq"] * c["lt"]
        name =(f"nq={c['nq']} lq={c['lq']} lt={c['lt']} lanes={c['lanes']} "
                f"{'reverse' if c['reverse'] else 'forward'} "
                f"go/ge={go}/{ge}"
                + (" all-negative" if c.get("negative") else "")
                + (" bound>TPU-pack-limit" if c.get("big") else ""))
        row = dict(case=name, equal=equal, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, cells_real=cells, cells_padded=padded,
                   gcups_real=cells / ms / 1e6, gcups_padded=padded / ms / 1e6,
                   bound_ms=bound, bound_by=by, bound_share=bound / ms,
                   max_score=int(got[0].max()))
        log("kernel-case " + json.dumps(row))
        if not equal:
            raise AssertionError(f"sw_multi differs from its plain version: "
                                 f"{name} (max abs err {err})")
        rows.append((c, row))
    return rows


# -- CLI helpers -------------------------------------------------------------------

def run_cli(args, cpu=False):
    from mmseqs2_tpu_torch.cli import main
    env = "MMSEQS2_TPU_TORCH_DEVICE"
    old = os.environ.get(env)
    os.environ[env] = "cpu" if cpu else "cuda"
    try:
        rc = main([str(a) for a in args])
    finally:
        if old is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = old
    if rc != 0:
        raise RuntimeError(f"command {args[0]} exited {rc}")


def entries(path):
    from mmseqs2_tpu_torch.db.reader import DBReader
    r = DBReader(str(path))
    return {r.get_db_key(i): r.get_data(i) for i in range(r.size)}


def phase_golden():
    alt = GOLDEN.parent / "alt"
    qdb, pref = GOLDEN / "qdb", GOLDEN / "pref"
    for name, dbs, extra, gold in (
            ("default -a", (qdb, qdb, pref), ["-a"], GOLDEN / "aln"),
            ("blosum62 13/2", (qdb, qdb, pref),
             ["--sub-mat", "blosum62.out", "--gap-open", "13",
              "--gap-extend", "2"], GOLDEN / "aln_blosum62_13_2"),
            ("realign", (qdb, qdb, GOLDEN / "it_pref_0"),
             ["-a", "1", "--realign", "1", "-e", "0.001"],
             GOLDEN / "it_aln_0"),
            ("alt-ali 2", (alt / "qd", alt / "td", alt / "pf"),
             ["-a", "--alt-ali", "2", "-e", "1e5"], alt / "refalt2"),
            ("corr-score-weight 0.1", (alt / "q8", qdb, alt / "prefsub"),
             ["-a", "--corr-score-weight", "0.1", "-e", "10"],
             alt / "refcorr")):
        out = WORK / f"golden_{gold.name}"
        t0 = time.perf_counter()
        run_cli(["align", *dbs, out, *extra])
        wall = time.perf_counter() - t0
        got, want = entries(out), entries(gold)
        bad = [k for k in want if got.get(k) != want[k]]
        log(f"golden {name}: {len(want)} queries, {len(bad)} differ, "
            f"{wall:.2f} s")
        if bad or len(got) != len(want):
            raise AssertionError(f"golden parity ({name}) fails for "
                                 f"queries {bad[:10]}")


def lengths(rng, n):
    return np.clip(rng.lognormal(mean=5.68, sigma=0.55, size=n), 50,
                   2000).astype(np.int64)


def write_fasta(path, names, seqs):
    aa = np.frombuffer(AA.encode(), dtype=np.uint8)
    with open(path, "w") as f:
        for name, s in zip(names, seqs):
            f.write(f">{name}\n{aa[s].tobytes().decode()}\n")


def make_scale_data(rng, n_targets, n_queries):
    """SwissProt-like targets in planted families, queries as mutated
    fragments of targets plus 10% unrelated (experiments/make_scale_db.py's
    recipe). Returns per-query family (or -1) and the target families."""
    n_fam = max(n_targets // 8, 1)
    ancestors = [rng.choice(20, size=int(L), p=PBACK)
                 for L in lengths(rng, n_fam)]
    tseqs, tnames, tfam = [], [], []
    for i in range(n_targets):
        f = int(rng.integers(n_fam))
        s = ancestors[f].copy()
        mut = rng.random(len(s)) < rng.uniform(0.15, 0.45)
        s[mut] = rng.choice(20, size=int(mut.sum()), p=PBACK)
        if rng.random() < 0.3:
            lo = int(rng.integers(0, max(len(s) // 4, 1)))
            hi = len(s) - int(rng.integers(0, max(len(s) // 4, 1)))
            s = s[lo:max(hi, lo + 50)]
        tseqs.append(s)
        tnames.append(f"T{i}")
        tfam.append(f)
    qseqs, qnames, qfam = [], [], []
    for i in range(n_queries):
        if rng.random() < 0.1:
            qseqs.append(rng.choice(20, size=int(lengths(rng, 1)[0]),
                                    p=PBACK))
            qnames.append(f"Q{i}")
            qfam.append(-1)
            continue
        t = int(rng.integers(n_targets))
        s = tseqs[t].copy()
        mut = rng.random(len(s)) < rng.uniform(0.1, 0.35)
        s[mut] = rng.choice(20, size=int(mut.sum()), p=PBACK)
        if rng.random() < 0.5 and len(s) > 120:
            lo = int(rng.integers(0, len(s) // 3))
            s = s[lo:lo + max(len(s) // 2, 100)]
        qseqs.append(s)
        qnames.append(f"Q{i}")
        qfam.append(tfam[t])
    write_fasta(WORK / "targets.fasta", tnames, tseqs)
    write_fasta(WORK / "queries.fasta", qnames, qseqs)
    return qfam, tfam


def name_to_key(db):
    out = {}
    with open(f"{db}.lookup") as f:
        for line in f:
            key, acc, _ = line.rstrip("\n").split("\t")
            out[acc] = int(key)
    return out


def phase_real_size(rng, n_targets=20_000, n_queries=1_000, max_seqs=300,
                    n_check=32):
    from mmseqs2_tpu_torch.align import aligner
    from mmseqs2_tpu_torch.db import dbtype as dbt
    from mmseqs2_tpu_torch.db.writer import DBWriter
    from mmseqs2_tpu_torch.ops import sw

    t0 = time.perf_counter()
    qfam, tfam = make_scale_data(rng, n_targets, n_queries)
    run_cli(["createdb", WORK / "queries.fasta", WORK / "qdb"])
    run_cli(["createdb", WORK / "targets.fasta", WORK / "tdb"])
    qkey, tkey = name_to_key(WORK / "qdb"), name_to_key(WORK / "tdb")
    members = {}
    for i, f in enumerate(tfam):
        members.setdefault(f, []).append(tkey[f"T{i}"])
    all_t = np.array([tkey[f"T{i}"] for i in range(n_targets)])
    # prefilter DB: the query's family members first, then random targets
    pref = {}
    for i, f in enumerate(qfam):
        cand = list(members.get(f, []))[:max_seqs]
        seen = set(cand)
        while len(cand) < max_seqs:
            for t in rng.choice(all_t, size=max_seqs, replace=False):
                t = int(t)
                if t not in seen and len(cand) < max_seqs:
                    seen.add(t)
                    cand.append(t)
        pref[qkey[f"Q{i}"]] = cand
    with DBWriter(str(WORK / "pref"), dbt.DBTYPE_PREFILTER_RES) as w:
        for k in sorted(pref):
            w.write(k, "".join(f"{t}\t0\t0\n" for t in pref[k]).encode())
    first = sorted(pref)[:n_check]
    with DBWriter(str(WORK / "pref_check"), dbt.DBTYPE_PREFILTER_RES) as w:
        for k in first:
            w.write(k, "".join(f"{t}\t0\t0\n" for t in pref[k]).encode())
    n_pairs = sum(len(v) for v in pref.values())
    log(f"real-size data: {n_targets} targets, {n_queries} queries, "
        f"{n_pairs} prefilter pairs, made in "
        f"{time.perf_counter() - t0:.2f} s")

    # the main path: counts set to 0 just before, read just after
    aligner.reset_stats()
    sw.sw_multi.launches = 0
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_cli(["align", WORK / "qdb", WORK / "tdb", WORK / "pref",
             WORK / "aln", "-a"])
    wall = time.perf_counter() - t0
    launches = sw.sw_multi.launches
    st = dict(aligner.STATS)
    if launches <= 0:
        raise AssertionError("the align run launched no sw_multi kernel")
    kernel_s = st["kernel_ms"] / 1e3
    other = wall - st["scan_s"] - st["backtrace_s"]
    res = dict(
        pairs=st["pairs"], rev_pairs=st["rev_pairs"], wall_s=wall,
        host_other_s=other, scan_host_s=st["scan_s"], kernel_s=kernel_s,
        backtrace_s=st["backtrace_s"], pairs_per_s=st["pairs"] / wall,
        cells_real=st["cells_real"], cells_padded=st["cells_padded"],
        gcups_real=st["cells_real"] / kernel_s / 1e9,
        gcups_padded=st["cells_padded"] / kernel_s / 1e9,
        launches=launches)
    log("real-size " + json.dumps(res))
    if st["pairs"] != n_pairs:
        raise AssertionError(f"{st['pairs']} pairs aligned, {n_pairs} "
                             f"expected")

    got = entries(WORK / "aln")
    if len(got) != n_queries or not any(got.values()):
        raise AssertionError("real-size align wrote no results")
    t0 = time.perf_counter()
    run_cli(["align", WORK / "qdb", WORK / "tdb", WORK / "pref_check",
             WORK / "aln_cpu", "-a"], cpu=True)
    cpu = entries(WORK / "aln_cpu")
    bad = [k for k in first if cpu[k] != got[k]]
    n_hits = sum(got[k].count(b"\n") for k in first)
    log(f"real-size CPU cross-check: first {n_check} queries ({n_hits} "
        f"hits), {len(bad)} differ, CPU run {time.perf_counter() - t0:.2f} s")
    if bad:
        raise AssertionError(f"card and CPU results differ for queries "
                             f"{bad[:10]}")
    return res


def device_spans_s(events):
    """Seconds in which the card ran anything (the union of the intervals
    of kernels, copies and memsets) in a chrome-trace event list, and the
    device time by name as {name: [count, seconds]}."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    busy, end, by_name = 0.0, float("-inf"), {}
    for e in sorted(dev, key=lambda e: float(e["ts"])):
        s = float(e["ts"])
        t = s + float(e.get("dur", 0.0))
        if t > end:
            busy += t - max(s, end)
            end = t
        k = by_name.setdefault(e["name"], [0, 0.0])
        k[0] += 1
        k[1] += float(e.get("dur", 0.0)) / 1e6
    return busy / 1e6, by_name


def phase_trace(untraced_wall):
    """The real-size `align -a` once more, under torch.profiler (CPU and
    CUDA activities), apart from the untraced run whose wall is the metric:
    the card's busy and idle shares of the traced wall, device time by
    kernel, and what tracing costs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_cli(["align", WORK / "qdb", WORK / "tdb", WORK / "pref",
                 WORK / "aln_traced", "-a"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = WORK / "align_trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        busy, by_name = device_spans_s(json.load(f)["traceEvents"])
    if busy <= 0:
        raise AssertionError("the profiler trace holds no device activity")
    if entries(WORK / "aln_traced") != entries(WORK / "aln"):
        raise AssertionError("the traced align run gave other results")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    res = dict(
        traced_wall_s=wall, untraced_wall_s=untraced_wall,
        tracing_overhead=wall / untraced_wall - 1, device_busy_s=busy,
        busy_share=busy / wall, idle_share=1 - busy / wall,
        device_s_by_name=[dict(name=n[:100], count=c, s=s)
                          for n, (c, s) in top])
    log("trace " + json.dumps(res))
    return res


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "mmseqs2_tpu_torch").is_dir() or not GOLDEN.is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    os.environ["MMSEQS2_TPU_TORCH_DEVICE"] = "cuda"
    t_start = time.perf_counter()
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir()
    rng = np.random.default_rng(SEED)

    # 1. card
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # 2. build
    from mmseqs2_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    report = kernels.build("sw")
    log(f"build: csrc/sw.cu in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas sw: {line.strip()}")

    # 3. kernels against their plain versions
    rows = phase_kernels(rng)

    # 4. golden parity on the card
    phase_golden()

    # 5. the main path at real size, then a traced rerun
    real = phase_real_size(rng)
    phase_trace(real["wall_s"])

    # 6. kernels line
    rep = next(r for c, r in rows if c["nq"] == 16 and c["lq"] == 512
               and c["lt"] == 512 and not c["reverse"] and c["go"] == 11
               and not c.get("negative") and not c.get("big"))
    kern = [dict(
        name="sw_multi", route="cuda",
        source="mmseqs2_tpu_torch/csrc/sw.cu",
        replaces="mmseqs2_tpu/ops/pallas_sw.py:106",
        launches=real["launches"],
        max_abs_err=max(r["max_abs_err"] for _, r in rows),
        ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
        bound_by=rep["bound_by"], library_ms=None,
        equal=all(r["equal"] for _, r in rows),
        at=rep["case"])]
    shutil.rmtree(WORK)
    log(f"total: {time.perf_counter() - t_start:.2f} s")
    log(f"card: {card}")
    print(json.dumps({"kernels": kern}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
