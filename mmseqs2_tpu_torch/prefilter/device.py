"""Device-resident batched k-mer prefilter (the QueryMatcher hot path).

Port of mmseqs2_tpu/prefilter/device.py to PyTorch, for protein sequence
and profile queries against one resident target index.

Reference semantics: src/prefiltering/QueryMatcher.cpp (matchQuery :103-241,
match :243-376, getResult :401-458), CacheFriendlyOperations.cpp
(findDuplicates :38-180), UngappedAlignment.cpp (diagonal rescore, 255 cap).
The host oracle is prefilter/query_matcher.py; tests cross-check hit-for-hit.

Instead of the reference's per-query OpenMP loop with radix-binned byte
arrays, a whole *batch* of queries is matched by one sequence of device
operations over buffers of the flush's own size:

  1. (qid, id)-stable sort    - replaces radix binning (one packed key)
  2. double-diagonal detect   - vectorized compares + a "last duplicate
                                wins" scan (the byte-array quirk: an id's
                                first entry with u8 diag 0 counts)
  3. compaction               - cumsum + scatter
  4. ungapped diagonal rescore- the hand-written kernel of ops/rescore.py,
                                exact scores, bounded by the device-side
                                candidate count as the reference's n_valid
                                (a grid sized to the card, no block for the
                                empty slots, nothing read back); the
                                prefilter score is min(exact, 255) and kept
                                hits that saturated take the exact value,
                                with no second pass
  5. keepMaxScoreElementOnly  - scatter max + scatter min tie-break
  6. adaptive score threshold - per-query 256-bin histogram
  7. top-K selection + final (score desc, id asc) ordering

The host prepares per-window similar-k-mer triples (KmerGenerator, or a
profile query's ProfileKmerGenerator), the CSR lookups and the posting
expansion; everything after that runs on the device. A profile query's
flush uploads its queries' rescore profiles, (B, Lq, 32) int8 (pssm/4 on
the 20 amino-acid columns, X at 0, no bias correction), and rescores with
the profile form of the kernel (diag_rescore_profile), as the JAX
package's _device_match does; its device-side posting expansion
(stage_candidates) is semantically identical to this host expansion and
stage_candidates_pre. A flush is enqueued without reading anything back
(match_batch_async); match_batch_wait is the one place that synchronises.
The rescoreHits truncation path (score threshold saturated at 255,
QueryMatcher.cpp:184-214) is detected on the device and those queries are
matched again by the host oracle; `host_oracle_queries` counts them.

The buffers have the sizes the flush has: the capacities of the JAX
version (a fixed query count, hit and candidate capacities, power-of-two
shape buckets) bounded its compiles and are gone. What stays is H_CAP_MAX,
a memory limit per device call: a batch over it is split in two, a single
query over it goes to the host oracle.
"""

import numpy as np
import torch

from ..ops.encode import calc_local_aa_bias
from ..ops.rescore import (diag_rescore, diag_rescore_profile, profile_rows,
                           window_cells)
from .device_stages import (stage_candidates_pre, stage_finalize,
                            stage_hist, stage_keepmax, stage_select,
                            threshold_from_hist)
from .kmer_index import extract_kmers
from .query_matcher import UCHAR_MAX, USHRT_MAX

NOT_PORTED = "is not yet ported (see ROADMAP.md)"
# the rescore record's histogram of window lengths: bins of WINDOW_BIN
# cells, the last one open (WINDOW_BIN * (WINDOW_BINS - 1) cells and more)
WINDOW_BIN = 8
WINDOW_BINS = 513


def device_match_pre(qtid, diag, t_cat, t_off, t_len, q_pad, corr, submat,
                     q_len, identity, *, n_q, max_hits, min_diag_thr, out_sz,
                     tb, record=None, prof=None):
    """Match a host-expanded flush on the device of its tensors.

    qtid (H,) i32 `qid << tb | id` and diag (H,) i16 (the u16 diagonal's
    bits) per expansion, in expansion order. Sequence queries are rescored
    from their letters (q_pad, corr, submat); profile queries from their
    rows, prof (B, Lq, 32) int8 (q_pad, corr and submat None). Returns
    (big, small): big
    (5, out_sz) i32 rows qid, id, diagonal, score, valid in final order;
    small = [n_cand, n_keep, total, truncated per query].

    `record` (a dict) receives the rescore's slots and the histogram of
    its valid windows' lengths on the device; nothing is read back."""
    c_cap = qtid.shape[0]
    cqid, cid, cdiag, cvalid, n_cand, total = stage_candidates_pre(
        qtid, diag, c_cap=c_cap, tb=tb)
    if prof is None:
        cexact = diag_rescore(cqid, cid, cdiag, cvalid, t_cat, t_off, t_len,
                              q_pad, corr, submat, q_len, n_cand)
    else:
        cexact = diag_rescore_profile(cqid, cid, cdiag, cvalid, t_cat, t_off,
                                      t_len, prof, q_len, n_cand)
    if record is not None:
        n = window_cells(cqid, cid, cdiag, cvalid, t_len, q_len, n_cand)
        hist = torch.zeros(WINDOW_BINS, dtype=torch.int64, device=n.device)
        hist.scatter_add_(0, (n // WINDOW_BIN).clamp(0, WINDOW_BINS - 1),
                          (n >= 0).long())
        record.update(slots=c_cap, windows=hist)
    cscore = cexact.clamp(max=UCHAR_MAX)
    is_best = stage_keepmax(cqid, cid, cscore, cvalid, c_cap=c_cap)
    hist = stage_hist(cqid, cscore, is_best, n_q=n_q, c_cap=c_cap)
    thr, truncated = threshold_from_hist(hist, max_hits, min_diag_thr)
    kqid, kid, kdiag, kscore, kexact, kvalid = stage_select(
        cqid, cid, cdiag, cscore, cexact, cvalid, is_best, thr, identity,
        c_cap=c_cap, max_hits=max_hits, out_sz=out_sz)
    # exact (uncapped) scores for saturated kept hits (getResult :430-436)
    final_score = torch.where(kvalid & (kscore >= UCHAR_MAX), kexact, kscore)
    oq, _, oid, odiag, ofs, oval = stage_finalize(
        kqid, kid, kdiag, final_score, kvalid)
    big = torch.stack([oq, oid, odiag, ofs, oval])
    small = torch.cat([
        torch.stack([n_cand, kvalid.sum(dtype=torch.int32), total]),
        truncated.to(torch.int32)])
    return big, small


class DevicePrefilter:
    """Batched device QueryMatcher. Holds the target store on the device;
    `match_batch` takes a batch of numeric queries and returns per-query hit
    lists identical to QueryMatcher.match()."""

    H_CAP_MAX = 1 << 25        # expanded hits per device call (memory limit)
    B_PAD = 128                # most queries per flush
    H_CAP_FIXED = 1 << 21      # expanded hits per flush the caller aims at

    def __init__(self, index_table, seed, ungapped, kmer_thr, kmer_size,
                 max_hits, aa_bias_corr=True, bias_scale=1.0,
                 min_diag_score_thr=15, generator=None,
                 take_only_best_kmer=False, host_fallback=None, device=None):
        from ..device import get_device
        self.device = torch.device(device) if device is not None \
            else get_device()
        self.index = index_table
        self.seed = seed
        self.ungapped = ungapped
        self.kmer_thr = kmer_thr
        self.k = kmer_size
        self.max_hits = max_hits
        self.aa_bias_corr = aa_bias_corr
        self.bias_scale = bias_scale
        self.min_diag_thr = min_diag_score_thr
        self.generator = generator
        self.take_only_best = take_only_best_kmer
        self.host_fallback = host_fallback   # QueryMatcher oracle
        self.x_index = seed.alphabet_size - 1
        self.host_oracle_queries = 0
        # bytes of profile-query rescore profiles uploaded with the flushes
        self.profile_bytes = 0
        # when set: one dict per flush's rescore (slots, valid candidates,
        # window-length histogram), filled by match_batch_wait
        self.record_rescore = False
        self.rescore_log = []

        seqs = index_table.masked_seqs
        if hasattr(seqs, "cat"):          # index_io.CatSeqs packed layout
            t_lens = (seqs.lens.astype(np.int32) if len(seqs)
                      else np.zeros(1, np.int32))
            t_cat = np.asarray(seqs.cat).view(np.int8)
        else:
            t_lens = np.array([len(s) for s in seqs] or [0], dtype=np.int32)
            t_cat = (np.concatenate(seqs) if len(seqs) else
                     np.zeros(0, np.uint8)).astype(np.uint8).view(np.int8)
        self.n_targets = len(seqs)
        t_off = np.concatenate([[0], np.cumsum(t_lens, dtype=np.int64)])
        if len(t_cat) == 0:
            t_cat = np.zeros(1, np.int8)
        # the target store, 1 B per residue; every window the rescore reads
        # lies inside its target by construction
        dev = self.device
        if not t_cat.flags.writeable:     # a read-only view of a loaded .idx
            t_cat = t_cat.copy()
        self.d_t_cat = torch.from_numpy(np.ascontiguousarray(t_cat)).to(dev)
        self.d_t_off = torch.from_numpy(
            t_off[:-1] if len(seqs) else np.zeros(1, np.int64)).to(dev)
        self.d_t_lens = torch.from_numpy(t_lens).to(dev)
        self.d_submat = torch.from_numpy(
            np.ascontiguousarray(ungapped.sub_matrix.astype(np.int32))
        ).to(dev)

    # -- host-side stage 0: windows -> similar k-mer triples ---------------
    def query_triples(self, q_num, comp_bias, generator=None):
        """(kmer codes, qpos) for one query, reference enumeration order.

        Whole-query vectorized similar-k-mer generation (the reference's
        per-window KmerGenerator::generateKmerList loop, QueryMatcher.cpp
        :255-284, batched as flat numpy segment ops, see
        kmer_generator._expand_batch)."""
        idx_all, pos_all, has_x = extract_kmers(
            q_num, self.index.offsets_pat, self.index.span,
            self.index.alpha, self.x_index)
        keep = ~has_x
        pos = pos_all[keep]
        if len(pos) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int32)
        if self.take_only_best:
            return idx_all[keep], pos.astype(np.int32)
        # per-window composition-bias threshold adjustment
        # (QueryMatcher.cpp:260-271 rounding)
        bias_f = comp_bias[pos[:, None] + self.index.offsets_pat[None, :]
                           ].sum(axis=1)
        bias = np.trunc(np.where(bias_f < 0.0, bias_f - 0.5,
                                 bias_f + 0.5)).astype(np.int64)
        thr = np.maximum(self.kmer_thr - bias, 0)
        windows = q_num[pos[:, None]
                        + self.index.offsets_pat[None, :]].astype(np.int64)
        gen = generator if generator is not None else self.generator
        codes, win_of = gen.generate_all(windows, thr, pos)
        return codes, pos[win_of].astype(np.int32)

    def prepare_query(self, q_num, rescore_profile=None, generator=None):
        """Host stage for one query.

        Returns (starts, counts, qpos, prof, corr, ids, diag): the CSR
        lookups of the similar k-mers, the rescore's inputs, and the
        host-side posting expansion: target ids (i32) and u16 diagonals per
        expanded match, in expansion order. A sequence query carries its i8
        bias correction (prof None); a profile query (its (L, 21) rescore
        profile and its ProfileKmerGenerator given) carries its int8
        (L, 32) profile rows and no correction: profiles take no
        composition bias (QueryMatcher.cpp:109-117)."""
        if rescore_profile is not None:
            comp_bias = np.zeros(len(q_num), np.float32)
            prof, corr = profile_rows(rescore_profile), None
        else:
            if self.aa_bias_corr:
                comp_bias = calc_local_aa_bias(
                    q_num, self.seed.sub_matrix, self.seed.pback,
                    self.bias_scale)
            else:
                comp_bias = np.zeros(len(q_num), np.float32)
            corr = np.trunc(np.where(comp_bias < 0.0, comp_bias / 4 - 0.5,
                                     comp_bias / 4 + 0.5)).astype(np.int8)
            prof = None
        codes, qpos = self.query_triples(q_num, comp_bias, generator)
        s, c = self.index.lists(codes)
        # drop empty posting lists: most similar k-mers miss the index
        # entirely (sparse k-mer space)
        nz = c > 0
        s, c, qpos = s[nz].astype(np.int32), c[nz].astype(np.int32), qpos[nz]
        ids, diag = self._expand_host(s, c, qpos)
        return (s, c, qpos, prof, corr, ids, diag)

    def _expand_host(self, starts, counts, qpos):
        """Posting expansion for one query: (ids i32, diag u16) per
        expanded (query window, index entry) match, expansion order."""
        total = int(counts.sum())
        if total == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.uint16)
        trip = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
        offs = np.concatenate([[0], np.cumsum(counts[:-1],
                                              dtype=np.int64)])
        within = np.arange(total, dtype=np.int64) - offs[trip]
        ent = starts[trip].astype(np.int64) + within
        ids = np.asarray(self.index.entries_seq)[ent].astype(np.int32,
                                                            copy=False)
        tpos = np.asarray(self.index.entries_pos)[ent]   # u16; upcasts
        diag = ((qpos[trip].astype(np.int32, copy=False) - tpos)
                & 0xFFFF).astype(np.uint16)
        return ids, diag

    def match_batch(self, queries, identity_ids, rescore_profiles=None,
                    generators=None, prepared=None):
        """queries: list of numeric query arrays. Returns list of hit-tuple
        lists [(local target id, prefScore, diagonal i32), ...].

        `prepared`: optional precomputed per-query stage-0 results
        (prepare_query's tuples): the flush loop streams these so the flush
        decision can see actual expansion volumes."""
        return self.match_batch_wait(self.match_batch_async(
            queries, identity_ids, rescore_profiles, generators, prepared))

    def match_batch_async(self, queries, identity_ids,
                          rescore_profiles=None, generators=None,
                          prepared=None):
        """Dispatch half of match_batch: host packing, copies and device
        work are enqueued, nothing is read back. Returns a pending handle
        for match_batch_wait, so the caller can dispatch flush N+1 before
        fetching flush N."""
        B = len(queries)
        if prepared is None:
            prepared = [self.prepare_query(
                q, rescore_profiles[b] if rescore_profiles else None,
                generators[b] if generators else None)
                for b, q in enumerate(queries)]
        total = sum(len(p[5]) for p in prepared)
        results = [[] for _ in range(B)]
        for b in range(B):
            if identity_ids[b] >= 0:
                results[b].append((identity_ids[b], USHRT_MAX, 0))
        if total == 0 or self.n_targets == 0:
            return {"done": results}
        # the packed qid << tb | id key must fit i32
        if max(B, self.B_PAD) << self._tb() >= (1 << 31):
            raise NotImplementedError(
                f"the device-side posting expansion for target sets past "
                f"the packed sort key {NOT_PORTED}")
        return self._match_pre_async(queries, identity_ids, prepared,
                                     results, total, rescore_profiles,
                                     generators)

    def _tb(self):
        """Bit width of the target-id field in the shift-packed sort key
        (an even width, as in the JAX version)."""
        b = max(int(self.n_targets - 1).bit_length(), 1)
        return (b + 1) & ~1

    def _host_match(self, query, identity_id, rescore_profile=None,
                    generator=None):
        """The host oracle's match of one query, with a profile query's
        generator and rescore profile."""
        self.host_oracle_queries += 1
        return self.host_fallback.match(
            query, identity_id, diagonal_scoring=True,
            rescore_profile=rescore_profile, generator=generator)

    def _match_pre_async(self, queries, identity_ids, prepared, results,
                         total, rescore_profiles=None, generators=None):
        """Dispatch a host-expanded flush (see device_match_pre)."""
        B = len(queries)
        if total > self.H_CAP_MAX:
            if B == 1:
                # single over-budget query: host oracle handles it
                if self.host_fallback is None:
                    raise MemoryError(
                        f"query hit volume {total} exceeds device capacity")
                return {"done": [self._host_match(
                    queries[0], identity_ids[0],
                    rescore_profiles[0] if rescore_profiles else None,
                    generators[0] if generators else None)]}
            return {"done": self._split_batch(queries, identity_ids,
                                              prepared, rescore_profiles,
                                              generators)}
        dev = self.device
        pin = dev.type == "cuda"
        qlens = [len(q) for q in queries]
        lq_max = max(qlens)
        tb = self._tb()

        def host(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)

        h_qtid, h_diag = host(total, torch.int32), host(total, torch.int16)
        h_meta = host((2, B), torch.int32)
        qtid, diag = h_qtid.numpy(), h_diag.numpy().view(np.uint16)
        off = 0
        for b, p in enumerate(prepared):
            n = len(p[5])
            qtid[off:off + n] = p[5] + np.int32(b << tb)
            diag[off:off + n] = p[6]
            off += n
        h_meta.numpy()[0] = qlens
        h_meta.numpy()[1] = identity_ids
        profile = prepared[0][3] is not None
        if profile:
            # the queries' rescore profiles, one 32-byte row a position
            h_rows = host((B, lq_max, prepared[0][3].shape[1]), torch.int8)
            rows = h_rows.numpy()
            rows[:] = 0
            for b, p in enumerate(prepared):
                rows[b, :qlens[b]] = p[3]
            staged = (h_rows,)
            self.profile_bytes += h_rows.numel()
        else:
            h_q = host((B, lq_max), torch.uint8)
            h_corr = host((B, lq_max), torch.int8)
            q_pad, corr = h_q.numpy(), h_corr.numpy()
            q_pad[:] = self.x_index
            corr[:] = 0
            for b, p in enumerate(prepared):
                q_pad[b, :qlens[b]] = queries[b]
                corr[b, :qlens[b]] = p[4]
            staged = (h_q, h_corr)
        d_qtid, d_diag, d_meta, *d_staged = (
            t.to(dev, non_blocking=True)
            for t in (h_qtid, h_diag, h_meta) + staged)
        rescore_in = (dict(q_pad=None, corr=None, submat=None,
                           prof=d_staged[0]) if profile else
                      dict(q_pad=d_staged[0], corr=d_staged[1],
                           submat=self.d_submat))
        record = {} if self.record_rescore else None
        big, small = device_match_pre(
            d_qtid, d_diag, self.d_t_cat, self.d_t_off, self.d_t_lens,
            q_len=d_meta[0], identity=d_meta[1],
            n_q=B, max_hits=self.max_hits, min_diag_thr=self.min_diag_thr,
            out_sz=max(min(total, B * self.max_hits), 1), tb=tb,
            record=record, **rescore_in)
        # the pinned buffers stay referenced until the flush is fetched
        return {"queries": queries, "identity_ids": identity_ids,
                "results": results, "big": big, "small": small,
                "host": (h_qtid, h_diag, h_meta) + staged,
                "record": record, "rescore_profiles": rescore_profiles,
                "generators": generators}

    def match_batch_wait(self, pend):
        """Fetch + post-process a match_batch_async dispatch."""
        if "done" in pend:
            return pend["done"]
        queries = pend["queries"]
        identity_ids = pend["identity_ids"]
        results = pend["results"]
        B = len(queries)
        big = pend["big"].cpu().numpy()
        small = pend["small"].cpu().numpy()
        rec = pend["record"]
        if rec is not None:
            self.rescore_log.append(dict(
                slots=rec["slots"], valid=int(small[0]),
                windows=rec["windows"].cpu().numpy()))
        oq, oid, odiag, ofs, oval = big
        truncated = small[3:3 + B].astype(bool)
        sel = np.nonzero(oval.astype(bool) & (oq < B))[0]
        oqs, oids, ofss = oq[sel], oid[sel], ofs[sel]
        diags = np.int16(odiag[sel].astype(np.uint16))
        bounds = np.searchsorted(oqs, np.arange(B + 1))
        for b in range(B):
            if truncated[b]:
                continue
            for i in range(int(bounds[b]), int(bounds[b + 1])):
                results[b].append((int(oids[i]), int(ofss[i]),
                                   int(diags[i])))
        if truncated.any() and self.host_fallback is not None:
            rps, gens = pend["rescore_profiles"], pend["generators"]
            for b in np.nonzero(truncated)[0]:
                results[b] = self._host_match(
                    queries[b], identity_ids[b], rps[b] if rps else None,
                    gens[b] if gens else None)
        return results

    def _split_batch(self, queries, identity_ids, prepared,
                     rescore_profiles=None, generators=None):
        mid = len(queries) // 2

        def sub(sl):
            return self.match_batch(
                queries[sl], identity_ids[sl],
                rescore_profiles[sl] if rescore_profiles else None,
                generators[sl] if generators else None, prepared[sl])
        return sub(slice(0, mid)) + sub(slice(mid, len(queries)))
