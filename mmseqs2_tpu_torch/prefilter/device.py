"""Device-resident batched k-mer prefilter (the QueryMatcher hot path).

Port of mmseqs2_tpu/prefilter/device.py to PyTorch, for plain protein
sequence queries against one resident target index.

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
                                exact scores; the prefilter score is
                                min(exact, 255) and kept hits that saturated
                                take the exact value, with no second pass
  5. keepMaxScoreElementOnly  - scatter max + scatter min tie-break
  6. adaptive score threshold - per-query 256-bin histogram
  7. top-K selection + final (score desc, id asc) ordering

The host prepares per-window similar-k-mer triples (KmerGenerator), the CSR
lookups and the posting expansion; everything after that runs on the
device. A flush is enqueued without reading anything back
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
from ..ops.rescore import diag_rescore
from .device_stages import (stage_candidates_pre, stage_finalize,
                            stage_hist, stage_keepmax, stage_select,
                            threshold_from_hist)
from .kmer_index import extract_kmers
from .query_matcher import UCHAR_MAX, USHRT_MAX

NOT_PORTED = "is not yet ported (see ROADMAP.md)"


def device_match_pre(qtid, diag, t_cat, t_off, t_len, q_pad, corr, submat,
                     q_len, identity, *, n_q, max_hits, min_diag_thr, out_sz,
                     tb):
    """Match a host-expanded flush on the device of its tensors.

    qtid (H,) i32 `qid << tb | id` and diag (H,) i16 (the u16 diagonal's
    bits) per expansion, in expansion order. Returns (big, small): big
    (5, out_sz) i32 rows qid, id, diagonal, score, valid in final order;
    small = [n_cand, n_keep, total, truncated per query]."""
    c_cap = qtid.shape[0]
    cqid, cid, cdiag, cvalid, n_cand, total = stage_candidates_pre(
        qtid, diag, c_cap=c_cap, tb=tb)
    cexact = diag_rescore(cqid, cid, cdiag, cvalid, t_cat, t_off, t_len,
                          q_pad, corr, submat, q_len)
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
    def query_triples(self, q_num, comp_bias):
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
        codes, win_of = self.generator.generate_all(windows, thr, pos)
        return codes, pos[win_of].astype(np.int32)

    def prepare_query(self, q_num, rescore_profile=None, generator=None):
        """Host stage for one plain sequence query.

        Returns (starts, counts, qpos, None, corr, ids, diag): the CSR
        lookups of the similar k-mers, the i8 bias correction, and the
        host-side posting expansion: target ids (i32) and u16 diagonals per
        expanded match, in expansion order. (The fourth slot held the
        per-query profile of the JAX version's device-expansion path.)"""
        if rescore_profile is not None or generator is not None:
            raise NotImplementedError(
                f"the profile-query prefilter {NOT_PORTED}")
        if self.aa_bias_corr:
            comp_bias = calc_local_aa_bias(
                q_num, self.seed.sub_matrix, self.seed.pback,
                self.bias_scale)
        else:
            comp_bias = np.zeros(len(q_num), np.float32)
        corr = np.trunc(np.where(comp_bias < 0.0, comp_bias / 4 - 0.5,
                                 comp_bias / 4 + 0.5)).astype(np.int32)
        codes, qpos = self.query_triples(q_num, comp_bias)
        s, c = self.index.lists(codes)
        # drop empty posting lists: most similar k-mers miss the index
        # entirely (sparse k-mer space)
        nz = c > 0
        s, c, qpos = s[nz].astype(np.int32), c[nz].astype(np.int32), qpos[nz]
        ids, diag = self._expand_host(s, c, qpos)
        return (s, c, qpos, None, corr.astype(np.int8), ids, diag)

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
        if rescore_profiles is not None or generators is not None:
            raise NotImplementedError(
                f"the profile-query prefilter {NOT_PORTED}")
        B = len(queries)
        if prepared is None:
            prepared = [self.prepare_query(q) for q in queries]
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
                                     results, total)

    def _tb(self):
        """Bit width of the target-id field in the shift-packed sort key
        (an even width, as in the JAX version)."""
        b = max(int(self.n_targets - 1).bit_length(), 1)
        return (b + 1) & ~1

    def _host_match(self, query, identity_id):
        self.host_oracle_queries += 1
        return self.host_fallback.match(query, identity_id,
                                        diagonal_scoring=True)

    def _match_pre_async(self, queries, identity_ids, prepared, results,
                         total):
        """Dispatch a host-expanded flush (see device_match_pre)."""
        B = len(queries)
        if total > self.H_CAP_MAX:
            if B == 1:
                # single over-budget query: host oracle handles it
                if self.host_fallback is None:
                    raise MemoryError(
                        f"query hit volume {total} exceeds device capacity")
                return {"done": [self._host_match(queries[0],
                                                  identity_ids[0])]}
            return {"done": self._split_batch(queries, identity_ids,
                                              prepared)}
        dev = self.device
        pin = dev.type == "cuda"
        qlens = [len(q) for q in queries]
        lq_max = max(qlens)
        tb = self._tb()

        def host(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)

        h_qtid, h_diag = host(total, torch.int32), host(total, torch.int16)
        h_q = host((B, lq_max), torch.uint8)
        h_corr = host((B, lq_max), torch.int8)
        h_meta = host((2, B), torch.int32)
        qtid, diag = h_qtid.numpy(), h_diag.numpy().view(np.uint16)
        q_pad, corr = h_q.numpy(), h_corr.numpy()
        q_pad[:] = self.x_index
        corr[:] = 0
        off = 0
        for b, p in enumerate(prepared):
            n = len(p[5])
            qtid[off:off + n] = p[5] + np.int32(b << tb)
            diag[off:off + n] = p[6]
            off += n
            q_pad[b, :qlens[b]] = queries[b]
            corr[b, :qlens[b]] = p[4]
        h_meta.numpy()[0] = qlens
        h_meta.numpy()[1] = identity_ids
        d_qtid, d_diag, d_q, d_corr, d_meta = (
            t.to(dev, non_blocking=True)
            for t in (h_qtid, h_diag, h_q, h_corr, h_meta))
        big, small = device_match_pre(
            d_qtid, d_diag, self.d_t_cat, self.d_t_off, self.d_t_lens,
            d_q, d_corr, self.d_submat, d_meta[0], d_meta[1],
            n_q=B, max_hits=self.max_hits, min_diag_thr=self.min_diag_thr,
            out_sz=max(min(total, B * self.max_hits), 1), tb=tb)
        # the pinned buffers stay referenced until the flush is fetched
        return {"queries": queries, "identity_ids": identity_ids,
                "results": results, "big": big, "small": small,
                "host": (h_qtid, h_diag, h_q, h_corr, h_meta)}

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
            for b in np.nonzero(truncated)[0]:
                results[b] = self._host_match(queries[b], identity_ids[b])
        return results

    def _split_batch(self, queries, identity_ids, prepared):
        mid = len(queries) // 2
        return (self.match_batch(queries[:mid], identity_ids[:mid],
                                 prepared=prepared[:mid])
                + self.match_batch(queries[mid:], identity_ids[mid:],
                                   prepared=prepared[mid:]))
