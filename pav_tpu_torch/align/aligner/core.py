"""Aligner core: chains -> base-level =/X CIGAR alignment records.

All inter-anchor gap segments from every contig are gathered first, bucketed by
(length, band) into static shapes, aligned in batched device DP calls
(pav_tpu.ops.affine_dp), then stitched back into per-chain CIGARs — maximizing
device batch occupancy instead of aligning contig-by-contig.

Alignment-breaking: a long inter-anchor segment whose bases are effectively
random (pre-DP equal-length mismatch check, or post-DP identity check) splits
the chain into separate alignment records — the analog of minimap2's Z-drop,
and the mechanism that produces the alignment-truncating signatures (large
INS/DEL and +,-,+ inversions) the downstream callers depend on. A second chain
-selection pass then maps query regions (e.g. inverted cores) left uncovered by
the primary chains.

Produces the reference's alignment-table records directly (no SAM round-trip);
schema: API_ALIGN.md:31-64.

Port of pav_tpu.align.aligner.core: the same planning and stitching, with the
DP on the torch port (pav_tpu_torch.ops.affine_dp) on an explicit device. The
class ladder is a parameter (``Aligner(ladder=...)``): ``'accel'`` is the
reference's accelerator branch (coarse classes, transposition, bucket
coalescing, the resident gather, wavefront bands), ``'cpu'`` its CPU branch
(fine pow2 classes, row bands, no transposition). By default a CPU device
takes the CPU ladder and a CUDA device the accelerator ladder, as the
reference picks by backend; ``ladder='accel'`` on a CPU device runs the
CUDA path's classes on the plain kernel versions.
"""

import collections
import threading

import numpy as np
import pandas as pd
import torch

from ... import seqcodec, spans
from ...align import cigar as cg
from ...align.table import ALIGN_COLUMNS, empty_align_table, sort_align_table

from ...ops import affine_dp
from .chain import find_chains
from .index import build_index

_MIN_WIDTH = 65

# The planning pool's wall, summed over runs (reset via align_stats_reset)
# by the ``hap`` of align_store: the ``align.plan`` span's duration. Every
# other phase of align_store is a span (``spans``).
ALIGN_STATS_BY_HAP = {}
_STATS_LOCK = threading.Lock()


def align_stats_reset():
    with _STATS_LOCK:
        ALIGN_STATS_BY_HAP.clear()


def _account_plan(hap, secs):
    with _STATS_LOCK:
        mine = ALIGN_STATS_BY_HAP.setdefault(hap, {})
        mine['plan_s'] = mine.get('plan_s', 0.0) + secs


_DIRECT_MISMATCH_FRAC = 0.05
_BREAK_MIN_LEN = 400        # segments at least this long can break an alignment
_BREAK_MISMATCH_FRAC = 0.30  # pre-DP: equal-length segment mismatch fraction
_BREAK_MIN_IDENTITY = 0.45   # post-DP: matched fraction of the longer side
_MIN_RECORD_ALIGNED = 50     # drop split records with fewer aligned bases
_MAX_EXTEND = 5000           # semi-global end extension cap per contig end


def _trim_ext_runs(lens, ops, scoring, reversed_frame, lq, lr):
    """Trim an end-extension's global-DP result to its best-scoring prefix.

    The extension DP is anchored at the chain side (position 0 of the segment)
    and global at the far side; cutting the run list at the maximum cumulative
    score reproduces free-end (Z-drop style) extension. The unaligned
    remainder is re-emitted as I/D runs at the outer side so record assembly
    strips it into clips.

    :return: [[len, op], ...] python run list in the oriented forward frame,
        consuming exactly (lq, lr).
    """
    match = scoring['match']
    mismatch = scoring['mismatch']
    o1, o2 = scoring['gap_open']
    e1, e2 = scoring['gap_ext']

    gap = np.minimum(o1 + e1 * lens.astype(np.int64),
                     o2 + e2 * lens.astype(np.int64))
    per_run = np.where(
        ops == cg.EQ, match * lens.astype(np.int64),
        np.where(ops == cg.X, mismatch * lens.astype(np.int64), -gap))
    cum = np.cumsum(per_run)
    if len(cum) == 0 or cum.max() <= 0:
        cut = 0
    else:
        cut = int(np.argmax(cum)) + 1

    kept = [[int(l), int(o)] for l, o in zip(lens[:cut], ops[:cut])]
    kept_q = int(np.sum(lens[:cut] * cg.CONSUMES_QRY[ops[:cut]])) if cut else 0
    kept_r = int(np.sum(lens[:cut] * cg.CONSUMES_REF[ops[:cut]])) if cut else 0
    rem = []
    if lq - kept_q > 0:
        rem.append([lq - kept_q, int(cg.I)])
    if lr - kept_r > 0:
        rem.append([lr - kept_r, int(cg.D)])
    if reversed_frame:
        return rem + kept[::-1]
    return kept + rem


def _bucket_pow2(x, lo=32, hi=1 << 15):
    v = lo
    while v < x and v < hi:
        v <<= 1
    return v


def _cpu_bucket(m, n):
    """(m_b, n_b, width_b) on the reference's CPU ladder: fine pow2 classes,
    rows (query) and columns (ref) padded independently, no transposition.
    Classes up to 256 get a band of 2|m-n| + 17 columns, larger ones of
    2|m-n| + 65; a band as wide as the row is full width."""
    m_b = _bucket_pow2(m, lo=16)
    n_b = _bucket_pow2(n, lo=16)
    if max(m_b, n_b) <= 256:
        width = 2 * abs(m - n) + 17
        width_b = min(_bucket_pow2(width, lo=16) + 1, n_b + 1)
    else:
        width = min(2 * abs(m - n) + _MIN_WIDTH, n + 1)
        width_b = min(_bucket_pow2(width, lo=256) + 1, n_b + 1)
    return m_b, n_b, width_b


def _cpu_shape_batch(m_b, width_b):
    """Batch cap of a class on the CPU ladder (the reference's CPU cap)."""
    return max(8, min(4096, (128 << 20) // max(m_b * width_b, 1)))


def resolve_ladder(ladder, device):
    """The class ladder for ``device``: ``ladder`` itself, or by default
    ``'cpu'`` for a CPU device and ``'accel'`` otherwise (the reference picks
    by ``jax.default_backend() != 'cpu'``)."""
    if ladder is None:
        return 'cpu' if torch.device(device).type == 'cpu' else 'accel'
    if ladder not in ('cpu', 'accel'):
        raise ValueError(f"ladder {ladder!r} is neither 'cpu' nor 'accel'")
    if ladder == 'cpu' and torch.device(device).type != 'cpu':
        raise ValueError(f'the CPU ladder runs row bands, which have no kernel on '
                         f'{device}: use the accelerator ladder there')
    return ladder


# Size ladder of the DP classes (the reference's accelerator ladder): pow2
# granularity at the small end where nearly all segments live (on the
# reference's bench genome 99.7% of DP segments have min-side <= 16), coarser
# steps above 2048 for the rare huge segments.
_ACCEL_LADDER = (16, 32, 64, 128, 256, 512, 1024, 2048, 8192, 32768)


def _bucket_ladder(x, ladder=_ACCEL_LADDER):
    for v in ladder:
        if x <= v:
            return v
    return ladder[-1]


# Largest padded (rows x width) cell count allowed through the full-width
# kernel: classes above this run banded (escapes break the record).
_FULL_CELLS_MAX = 1 << 23


def _accel_bucket(m, n):
    """(m_b, n_b, width_b) for the accelerator class ladder.

    Callers orient segments so m <= n first (_run_segments transposes and
    swaps I/D in the result): the DP scan is sequential over rows, so rows =
    the shorter side minimizes scan depth and halves the class count.

    Classes <= 512 and unbalanced classes run full width (exact DP, no
    band-escape retries). Balanced large classes run a banded window when the
    segment hugs the diagonal; escapes re-run at full width.
    """
    m_b = _bucket_ladder(m)
    n_b = _bucket_ladder(n)
    if max(m_b, n_b) <= 2048 or (m_b != n_b
                                 and m_b * (n_b + 1) <= _FULL_CELLS_MAX):
        # Full width: exact DP on the row kernel (dp_kernels.align_full).
        return m_b, n_b, n_b + 1
    w_need = 2 * abs(m - n) + _MIN_WIDTH
    if w_need <= 513:
        return m_b, n_b, 512      # runs at width 513
    # Widest band. Full width is NOT a fallback here: a balanced-huge class
    # (e.g. 8192x8193) would write an m x n tape per item. A segment whose
    # optimal path
    # leaves a 2k band either retries at full width when small enough
    # (_run_segments) or becomes an alignment-record break — the same
    # treatment reference aligners give paths that exceed their -r bandwidth
    # (rules/align.snakefile:188), whose SVs the truncation caller recovers.
    return m_b, n_b, 2048


def _shape_batch(m_b, width_b, n_b=None, device_type='cuda'):
    """Batch cap for a DP class (pow2).

    CUDA: the in-flight traceback tape stays under 512M cells (512 MB uint8);
    banded classes run the wavefront kernel, whose tape is (m+n) x
    wave_width cells. CPU: a 4M-cell cap, which only changes batch padding
    (items are independent).
    """
    cells = m_b * width_b
    if n_b is not None and width_b < n_b + 1:
        cells = max(cells, (m_b + n_b) * affine_dp._wave_width(width_b))
    budget = (512 << 20) if device_type == 'cuda' else (4 << 20)
    cap = max(8, min(16384, budget // max(cells, 1)))
    return 1 << (cap.bit_length() - 1)


def _resolve_handles(handles):
    """Collect align_batch_async handles in launch order (every launch is
    queued before the first wait)."""
    return [h() for h in handles]


class _Segment:
    __slots__ = ('q', 'r', 'kind', 'result', 'qdesc', 'rdesc')

    def __init__(self, q, r, kind='dp', qdesc=None, rdesc=None):
        self.q = q
        self.r = r
        # 'dp' | 'break' | 'ext_l' | 'ext_r' (end extensions; ext_l holds the
        # sequences reversed so the anchored end sits at position 0).
        self.kind = kind
        self.result = None
        # Provenance for device-resident gathering: (src_arr, off, len, rev)
        # describing this exact array as a (possibly reversed) slice of a
        # host source array uploaded once per run. None -> host-array path.
        self.qdesc = qdesc
        self.rdesc = rdesc


def _sub_desc(d, u, v):
    """Descriptor for arr[u:v] where d = (src, off, ln, rev) describes arr as
    a (reversed?) slice src[off:off+ln]."""
    if d is None or v <= u:
        return None
    src, off, ln, rev = d
    if not rev:
        return (src, off + u, v - u, rev)
    return (src, off + ln - v, v - u, rev)


def _rev_desc(d):
    """Descriptor for arr[::-1]."""
    if d is None:
        return None
    src, off, ln, rev = d
    return (src, off, ln, not rev)


def _parse_minimap2_scoring(params):
    """Scoring overrides from a minimap2 parameter string (the reference's
    minimap2_params config key, CONFIG.md:186): -B mismatch, -O open pair,
    -E extend pair. Unknown flags are ignored."""
    out = {}
    if not params:
        return out
    toks = str(params).split()
    for i, tok in enumerate(toks):
        val = toks[i + 1] if i + 1 < len(toks) else ''
        try:
            if tok == '-B':
                out['mismatch'] = -abs(int(val))
            elif tok == '-O':
                out['gap_open'] = tuple(int(v) for v in val.split(','))[:2]
            elif tok == '-E':
                out['gap_ext'] = tuple(int(v) for v in val.split(','))[:2]
        except ValueError:
            continue
    return out


class Aligner:
    """Contig-to-reference aligner over SeqStores."""

    # Alternate parameterizations of the one engine (the reference's
    # minimap2-vs-LRA choice: rules/align.snakefile:176-221, SURVEY.md §2.7).
    PRESETS = {
        'native': {},
        'native-sensitive': {'aligner_k': 15, 'aligner_w': 6,
                             'aligner_max_occ': 256,
                             'aligner_min_chain_score': 500},
    }

    # Reference aligner names map to presets of the one engine so reference
    # configs run unmodified (rules/align.snakefile:176-221).
    ALIASES = {'minimap2': 'native', 'lra': 'native-sensitive'}

    def __init__(self, ref_store, config=None, device=None, ladder=None):
        cfg = dict(config or {})
        name = str(cfg.get('aligner', 'native'))
        preset = self.PRESETS.get(self.ALIASES.get(name, name))
        if preset:
            from ...config import DEFAULTS
            for key, val in preset.items():
                # Preset overrides framework defaults but not explicit settings.
                if key not in cfg or cfg.get(key) == DEFAULTS.get(key):
                    cfg[key] = val
        # Scoring from a reference-style minimap2_params string (-O a,b -E a,b
        # -B x) when present; explicit aligner_* settings still win.
        mm_scoring = _parse_minimap2_scoring(cfg.get('minimap2_params'))
        self.ref_store = ref_store
        self.k = int(cfg.get('aligner_k', 19))
        self.w = int(cfg.get('aligner_w', 10))
        self.max_occ = int(cfg.get('aligner_max_occ', 64))
        self.chain_max_dist = int(cfg.get('aligner_chain_max_dist', 50000))
        self.chain_max_gap = int(cfg.get('aligner_chain_max_gap_diff', 10000))
        self.min_chain_score = float(cfg.get('aligner_min_chain_score', 1000))
        scoring = {
            'match': int(cfg.get('aligner_match', 1)),
            'mismatch': int(cfg.get('aligner_mismatch',
                                    mm_scoring.get('mismatch', -5))),
            'gap_open': tuple(cfg.get('aligner_gap_open',
                                      mm_scoring.get('gap_open', (5, 56)))),
            'gap_ext': tuple(cfg.get('aligner_gap_ext',
                                     mm_scoring.get('gap_ext', (4, 1)))),
        }
        self.dp = affine_dp.BandedAligner(scoring, device=device)
        self.scoring = self.dp.scoring
        self.device = self.dp.device
        self.ladder = resolve_ladder(ladder, self.device)
        self.index = build_index(ref_store, self.k, self.w, self.device)

    # ------------------------------------------------------------------ align

    def align_store(self, qry_store, hap, batch_count=10, min_chain_score=None):
        """Align every contig of a haplotype store; returns the alignment table
        (trim-none tier; CALL_BATCH/TRIM fields added by finalize_align_table)."""
        min_score = self.min_chain_score if min_chain_score is None else min_chain_score

        def plan_contig(qry_name):
            """Seed/chain/select/plan one contig into its own segment list
            (a task of the planning pool: an ``align.plan_contig`` span)."""
            prep = prepared.get(qry_name)
            codes = prep[False] if prep else qry_store.get(qry_name)
            qlen = len(codes)
            spans.add(bases=qlen)
            segments = []
            with spans.span('align.chains'):
                chains = find_chains(
                    codes, self.index, max_occ=self.max_occ,
                    max_dist=self.chain_max_dist, max_gap_diff=self.chain_max_gap,
                    min_chain_score=min_score, device=self.device)

            oriented_cache = dict(prep) if prep else {}

            def oriented(is_rev):
                if is_rev not in oriented_cache:
                    oriented_cache[is_rev] = seqcodec.revcomp(codes) if is_rev else codes
                return oriented_cache[is_rev]

            # Pass 1: primary selection by original-frame query-span overlap.
            with spans.span('align.select'):
                accepted, _ = self._select(chains, qlen, [])
            with spans.span('align.plan_chain'):
                metas = [
                    self._plan_chain(c, qry_name, qlen, oriented(c.is_rev), segments)
                    for c in accepted
                ]

            # Coverage excluding break segments; pass 2 fills the gaps
            # (e.g. the inverted core of a bridged inversion).
            with spans.span('align.select'):
                covered = []
                for meta in metas:
                    covered.extend(self._covered_spans(meta, segments, qlen))
                remaining = [c for c in chains if c not in accepted]
                accepted2, _ = self._select(remaining, qlen, covered)
            with spans.span('align.plan_chain'):
                for c in accepted2:
                    metas.append(self._plan_chain(
                        c, qry_name, qlen, oriented(c.is_rev), segments))

            # Semi-global end extension: chains stop at their terminal anchors,
            # leaving anchor-free contig tails (e.g. SNV-dense divergence)
            # unaligned. Extend the outermost chain toward each contig end
            # (reference aligners extend with Z-drop: minimap2 -z; the
            # best-prefix trim in _chain_records is the analog).
            with spans.span('align.extend'):
                self._plan_end_extensions(metas, segments, qlen, oriented)
            spans.add(chains=len(metas))
            return metas, segments

        names = qry_store.names()

        # Accelerator ladder: upload every sequence the plans can slice (ref
        # chromosomes + forward contigs) once; launches then carry only
        # window descriptors. The CPU ladder launches the padded sequences.
        prepared = {}
        resident = base_map = None
        rc_map = {}
        if self.ladder == 'accel':
            with spans.span('align.resident'):
                arrays = [self.ref_store.get(c) for c in self.ref_store.names()]
                for name in names:
                    codes = qry_store.get(name)
                    prepared[name] = {False: codes, True: seqcodec.revcomp(codes)}
                    arrays.append(codes)
                resident, base_map = _build_resident_from(arrays, self.dp.devices)
                # Reverse-complement arrays are never uploaded: a window of the
                # rc contig maps onto the forward buffer with the gather's
                # reverse+complement flags (halves the resident buffer).
                for name in names:
                    fwd = prepared[name][False]
                    rc_map[id(prepared[name][True])] = (base_map[id(fwd)], len(fwd))

        # Contigs are independent until DP batching; the hot pieces (native
        # sketch/chain, numpy) release the GIL.
        from ...parallel import pools
        with spans.span('align.plan') as plan:
            with pools.Executor('plan', min(4, len(names)),
                                task_span='align.plan_contig') as pool:
                results = list(pool.map(plan_contig, names))

            # Merge per-contig segment lists, rebasing part references.
            chain_meta = []
            segments = []
            for metas, segs in results:
                base = len(segments)
                for meta in metas:
                    meta['parts'] = [
                        (p[0], p[1] + base) if p[0] == 'seg' else p
                        for p in meta['parts']
                    ]
                    chain_meta.append(meta)
                segments.extend(segs)
        _account_plan(hap, plan.seconds)

        with spans.span('align.dp', segments=len(segments)):
            self._run_segments(segments, resident, base_map, rc_map)
        with spans.span('align.emit'):
            return self._emit_table(chain_meta, segments, hap)

    # -------------------------------------------------------------- selection

    @staticmethod
    def _orig_span(chain, qlen, k):
        lo, hi = chain.q_span()
        hi += k
        if chain.is_rev:
            return qlen - hi, qlen - lo
        return lo, hi

    def _select(self, chains, qlen, covered, max_overlap_frac=0.5):
        """Greedy best-score-first selection of chains whose original-frame
        query spans overlap accepted+covered spans by < max_overlap_frac."""
        spans = _coalesce_spans(list(covered))
        n_base = len(spans)
        # Pre-sized span arrays (appends were O(n^2) copies) + vectorized
        # competitor updates: the rejected->accepted inner loop was 6.6s of a
        # chromosome-scale run.
        cap = n_base + len(chains)
        lo_arr = np.empty(cap, dtype=np.int64)
        hi_arr = np.empty(cap, dtype=np.int64)
        for i, (s, e) in enumerate(spans):
            lo_arr[i] = s
            hi_arr[i] = e
        n_spans = n_base
        accepted = []
        best_sec = np.zeros(len(chains), dtype=np.float64)
        for c in sorted(chains, key=lambda c: -c.score):
            lo, hi = self._orig_span(c, qlen, self.k)
            length = hi - lo
            if length <= 0:
                continue
            if n_spans:
                overlap = int(np.maximum(
                    0, np.minimum(hi_arr[:n_spans], hi)
                    - np.maximum(lo_arr[:n_spans], lo)).sum())
            else:
                overlap = 0
            if overlap <= max_overlap_frac * length:
                c.best_secondary = 0.0
                accepted.append(c)
                lo_arr[n_spans] = lo
                hi_arr[n_spans] = hi
                n_spans += 1
            elif accepted:
                # Record the strongest rejected competitor per accepted chain
                # (drives the MAPQ second-best ratio). Accepted spans are the
                # tail [n_base:n_spans] of the arrays, in accept order.
                ov = (np.minimum(hi_arr[n_base:n_spans], hi)
                      - np.maximum(lo_arr[n_base:n_spans], lo)) > 0
                hit = np.nonzero(ov)[0]
                if len(hit):
                    np.maximum.at(best_sec, hit, c.score)
        for j, a in enumerate(accepted):
            if best_sec[j] > 0:
                a.best_secondary = best_sec[j]
        return accepted, list(zip(lo_arr[:n_spans].tolist(),
                                  hi_arr[:n_spans].tolist()))

    @staticmethod
    def _mapq(chain):
        """MAPQ from the primary/secondary score ratio (minimap2-flavored)."""
        sec = getattr(chain, 'best_secondary', 0.0)
        if chain.score <= 0:
            return 0
        ratio = 1.0 - min(sec / chain.score, 1.0)
        return int(min(60, round(60 * ratio)))

    def _covered_spans(self, meta, segments, qlen):
        """Original-frame query spans aligned by this chain, with break-segment
        sub-spans removed."""
        spans = []
        q_cur = meta['q_start']
        for part in meta['parts']:
            if part[0] == 'cig':
                adv_q = sum(l for l, o in part[1] if cg.CONSUMES_QRY[o])
                spans.append((q_cur, q_cur + adv_q))
                q_cur += adv_q
            else:
                seg = segments[part[1]]
                if seg.kind != 'break':
                    spans.append((q_cur, q_cur + len(seg.q)))
                q_cur += len(seg.q)
        out = []
        for lo, hi in spans:
            if hi <= lo:
                continue
            if meta['is_rev']:
                lo, hi = qlen - hi, qlen - lo
            out.append((lo, hi))
        return _coalesce_spans(out)

    # ------------------------------------------------------------ extension

    def _plan_end_extensions(self, metas, segments, qlen, oriented):
        """Register extension DP segments for the contig tails outside all
        selected chains' coverage (bounded by _MAX_EXTEND per end)."""
        if not metas:
            return
        # Original-frame outermost coverage over all chains of this contig.
        # Chain boundaries are anchors, so each chain's outer coverage is its
        # (q_start, q_end) span (recorded at planning; no parts re-walk).
        lo_min, lo_meta = qlen, None
        hi_max, hi_meta = 0, None
        for meta in metas:
            if meta['is_rev']:
                lo, hi = qlen - meta['q_end'], qlen - meta['q_start']
            else:
                lo, hi = meta['q_start'], meta['q_end']
            if hi <= lo:
                continue
            if lo < lo_min:
                lo_min, lo_meta = lo, meta
            if hi > hi_max:
                hi_max, hi_meta = hi, meta
        if lo_meta is not None and 0 < lo_min:
            self._plan_one_extension(
                lo_meta, segments, qlen, oriented, 'start',
                min(lo_min, _MAX_EXTEND))
        if hi_meta is not None and hi_max < qlen:
            self._plan_one_extension(
                hi_meta, segments, qlen, oriented, 'end',
                min(qlen - hi_max, _MAX_EXTEND))

    def _plan_one_extension(self, meta, segments, qlen, oriented, orig_end, e):
        """Extend one chain by e query bases toward a contig end (original
        frame); the DP result is trimmed to its best-scoring prefix when the
        record is materialized."""
        if e <= 0:
            return
        is_rev = meta['is_rev']
        codes = oriented(is_rev)
        ref = self.ref_store.get(meta['chrom'])
        qd0 = (codes, 0, qlen, False)
        rd0 = (ref, 0, len(ref), False)
        # Original-frame contig start maps to the oriented-frame left end for
        # forward chains and the right end for reverse chains.
        left = (orig_end == 'start') != is_rev
        slack = min(e // 8 + 32, 512)
        if left:
            q_start, r_start = meta['q_start'], meta['r_start']
            e = min(e, q_start)
            w0 = min(e + slack, r_start)
            if e <= 0 or w0 <= 0:
                return
            seg = _Segment(codes[q_start - e:q_start][::-1].copy(),
                           ref[r_start - w0:r_start][::-1].copy(), 'ext_l',
                           qdesc=_rev_desc(_sub_desc(qd0, q_start - e, q_start)),
                           rdesc=_rev_desc(_sub_desc(rd0, r_start - w0, r_start)))
            segments.append(seg)
            meta['q_start'] = q_start - e
            meta['r_start'] = r_start - w0
            meta['parts'].insert(0, ('seg', len(segments) - 1))
        else:
            q_end, r_end = meta['q_end'], meta['r_end']
            e = min(e, qlen - q_end)
            w0 = min(e + slack, len(ref) - r_end)
            if e <= 0 or w0 <= 0:
                return
            seg = _Segment(codes[q_end:q_end + e].copy(),
                           ref[r_end:r_end + w0].copy(), 'ext_r',
                           qdesc=_sub_desc(qd0, q_end, q_end + e),
                           rdesc=_sub_desc(rd0, r_end, r_end + w0))
            segments.append(seg)
            meta['parts'].append(('seg', len(segments) - 1))

    # ------------------------------------------------------------- chain plan

    def _plan_chain(self, chain, qry_name, qlen, oriented, segments):
        """Decompose a chain into exact runs and DP segments; register jobs.

        Vectorized: anchors collapse to boundary events (non-contiguous
        anchor pairs); the Python loop touches only boundaries (~#variants),
        not the millions of contiguous anchors.
        """
        k = self.k
        chrom = self.index.chrom_names[chain.chrom_id]
        ref = self.ref_store.get(chrom)
        qpos, rpos = chain.qpos, chain.rpos

        # Provenance of the oriented/ref arrays for device-resident gathering.
        qd0 = (oriented, 0, qlen, False)
        rd0 = (ref, 0, len(ref), False)

        parts = []

        if chain.n_anchors == 1:
            parts.append(('cig', [[k, cg.EQ]]))
        else:
            dq = np.diff(qpos)
            dr = np.diff(rpos)
            boundary = ~((dq == dr) & (dq <= k))
            b_idx = np.nonzero(boundary)[0]  # anchor-gap index a-1 -> pair (a-1, a)

            # Batched mismatch classification for the equal-length boundary
            # segments (the common case: SNVs and small substitutions): one
            # gather + reduceat replaces three numpy calls per tiny segment —
            # the per-boundary Python/numpy overhead otherwise dominates
            # chromosome-scale planning (measured 23s of a 63s run).
            bq0 = qpos[b_idx].astype(np.int64)
            br0 = rpos[b_idx].astype(np.int64)
            bq1 = qpos[b_idx + 1].astype(np.int64)
            br1 = rpos[b_idx + 1].astype(np.int64)
            bcut = np.maximum(0, np.maximum(k - (bq1 - bq0), k - (br1 - br0)))
            bsq0 = bq0 + k - bcut
            bsr0 = br0 + k - bcut
            blq = bq1 - bsq0
            blr = br1 - bsr0
            hints = {}
            eq_sel = np.nonzero((blq == blr) & (blq > 0))[0]
            if len(eq_sel):
                lens_e = blq[eq_sel]
                offs = np.zeros(len(lens_e) + 1, dtype=np.int64)
                np.cumsum(lens_e, out=offs[1:])
                total = int(offs[-1])
                rel = np.arange(total, dtype=np.int64) - np.repeat(offs[:-1], lens_e)
                gq = np.repeat(bsq0[eq_sel], lens_e) + rel
                gr = np.repeat(bsr0[eq_sel], lens_e) + rel
                oq = oriented[gq]
                mism_all = (oq != ref[gr]) | (oq >= 4)
                # reduceat keeps the operand dtype — bool would saturate at 1
                counts_e = (np.add.reduceat(mism_all.astype(np.int32), offs[:-1])
                            if total else np.zeros(0, np.int32))
                # Mismatch POSITIONS, globally once: per-boundary nonzero
                # calls were ~3-5 us each x one-per-variant at chromosome
                # scale. rel_nz holds boundary-relative positions; cum splits
                # them per boundary.
                nz = np.flatnonzero(mism_all)
                rel_nz = rel[nz].tolist() if len(nz) else []
                cum = np.zeros(len(eq_sel) + 1, dtype=np.int64)
                np.cumsum(counts_e, out=cum[1:])
                cum_l = cum.tolist()
                lens_l = lens_e.tolist()
                counts_l = counts_e.tolist()
                for j, sel in enumerate(eq_sel.tolist()):
                    hints[sel] = (counts_l[j],
                                  rel_nz[cum_l[j]:cum_l[j + 1]], lens_l[j])

            # Plain-int views: the loop below runs once per VARIANT at
            # chromosome scale (~300k iterations per 100 Mbp hap); numpy
            # scalar extraction + int() casts were ~30% of planning wall.
            bq0_l = bq0.tolist()
            bq1_l = bq1.tolist()
            br1_l = br1.tolist()
            bcut_l = bcut.tolist()
            bsq0_l = bsq0.tolist()
            bsr0_l = bsr0.tolist()
            qpos_l = qpos.tolist()
            b_idx_l = b_idx.tolist()
            direct_cap = None

            seg_start = 0  # anchor index where the current exact run started
            for pos_i, bi in enumerate(b_idx_l):
                q0 = bq0_l[pos_i]
                q1, r1 = bq1_l[pos_i], br1_l[pos_i]
                run_len = k + (q0 - qpos_l[seg_start]) - bcut_l[pos_i]
                if run_len > 0:
                    parts.append(('cig', [[run_len, cg.EQ]]))
                seg_q0 = bsq0_l[pos_i]
                seg_r0 = bsr0_l[pos_i]
                hint = hints.get(pos_i)
                if hint is not None:
                    # Inline _add_segment's equal-length fast path (the
                    # overwhelmingly common case: SNVs / small substitution
                    # runs) — no slices, descriptors, numpy, or call
                    # overhead: mismatch positions are plain ints from the
                    # one global pass above.
                    n_mism, pos_list, lq = hint
                    if direct_cap is None:
                        direct_cap = _DIRECT_MISMATCH_FRAC
                    if n_mism <= max(2, direct_cap * lq):
                        parts.append(('cig', _runs_from_positions(lq, pos_list)))
                        seg_start = bi + 1
                        continue
                self._add_segment(oriented[seg_q0:q1], ref[seg_r0:r1], parts, segments,
                                  qd=_sub_desc(qd0, seg_q0, q1),
                                  rd=_sub_desc(rd0, seg_r0, r1),
                                  mism_hint=hint)
                seg_start = bi + 1
            run_len = k + (qpos_l[-1] - qpos_l[seg_start])
            parts.append(('cig', [[run_len, cg.EQ]]))

        return {
            'qry_name': qry_name, 'qlen': qlen, 'is_rev': chain.is_rev,
            'chrom': self.index.chrom_names[chain.chrom_id],
            'q_start': int(qpos[0]), 'r_start': int(rpos[0]),
            'q_end': int(qpos[-1]) + k, 'r_end': int(rpos[-1]) + k,
            'score': chain.score, 'n_anchors': chain.n_anchors,
            'mapq': self._mapq(chain),
            'parts': parts,
        }

    def _add_segment(self, sq, sr, parts, segments, depth=0, qd=None, rd=None,
                     mism_hint=None):
        """Register one inter-anchor gap; fast paths avoid DP when possible.

        :param mism_hint: optional (n_mism, mismatch position list, length)
            precomputed by the caller's batched pass over all boundaries
            (one gather + reduceat + flatnonzero for the whole chain).
        """
        lq, lr = len(sq), len(sr)
        if lq == 0 and lr == 0:
            return
        if lq == 0:
            parts.append(('cig', [[lr, cg.D]]))
            return
        if lr == 0:
            parts.append(('cig', [[lq, cg.I]]))
            return
        if lq == lr:
            if mism_hint is not None:
                n_mism = mism_hint[0]
            else:
                mism = (sq != sr) | (sq >= 4)
                n_mism = int(np.count_nonzero(mism))
            if n_mism <= max(2, _DIRECT_MISMATCH_FRAC * lq):
                parts.append(('cig', _runs_from_positions(lq, mism_hint[1])
                              if mism_hint is not None
                              else _compare_runs_list(mism)))
                return
            if lq >= _BREAK_MIN_LEN and n_mism >= _BREAK_MISMATCH_FRAC * lq:
                # Effectively unalignable (Z-drop analog): break the record here.
                seg = _Segment(sq, sr, kind='break')
                parts.append(('seg', len(segments)))
                segments.append(seg)
                return

        # Large balanced segments (SV clusters between minimizer anchors):
        # re-anchor with unique-k-mer (MUM-style) matches and recurse, turning
        # one quadratic DP into exact runs + small sub-DPs.
        if depth < 3 and min(lq, lr) >= 512:
            if self._refine_segment(sq, sr, parts, segments, depth, qd, rd):
                return

        seg = _Segment(sq, sr, qdesc=qd, rdesc=rd)
        parts.append(('seg', len(segments)))
        segments.append(seg)

    _REFINE_K = 21

    def _refine_segment(self, sq, sr, parts, segments, depth, qd=None, rd=None):
        """Split a big segment along collinear unique-k-mer anchors.

        :return: True when refinement succeeded (parts appended), False to fall
            back to one DP segment.
        """
        from ... import kmer as km

        k2 = self._REFINE_K
        qk, qv = km.kmer_codes(sq, k2)
        rk, rv = km.kmer_codes(sr, k2)
        q_idx = np.nonzero(qv)[0]
        r_idx = np.nonzero(rv)[0]
        if len(q_idx) == 0 or len(r_idx) == 0:
            return False

        # Unique k-mers on each side.
        qu_vals, qu_first, qu_counts = np.unique(qk[q_idx], return_index=True,
                                                 return_counts=True)
        ru_vals, ru_first, ru_counts = np.unique(rk[r_idx], return_index=True,
                                                 return_counts=True)
        qu_mask = qu_counts == 1
        ru_mask = ru_counts == 1
        common, qi, ri = np.intersect1d(qu_vals[qu_mask], ru_vals[ru_mask],
                                        return_indices=True)
        if len(common) < 3:
            return False

        aq = q_idx[qu_first[qu_mask][qi]]
        ar = r_idx[ru_first[ru_mask][ri]]
        order = np.argsort(aq, kind='stable')
        aq, ar = aq[order], ar[order]

        # Longest increasing subsequence on ar (collinear anchor chain).
        lis_idx = _lis_indices(ar)
        if len(lis_idx) < 3:
            return False
        aq, ar = aq[lis_idx], ar[lis_idx]

        # Require the anchors to meaningfully cover the segment.
        if (aq[-1] - aq[0]) < 0.25 * len(sq) and (ar[-1] - ar[0]) < 0.25 * len(sr):
            return False

        # Stitch: leading sub-segment, anchor runs + gaps, trailing sub-segment.
        prev_q, prev_r = 0, 0
        run_len = 0
        for i in range(len(aq)):
            q0, r0 = int(aq[i]), int(ar[i])
            if i == 0:
                self._add_segment(sq[:q0], sr[:r0], parts, segments, depth + 1,
                                  _sub_desc(qd, 0, q0), _sub_desc(rd, 0, r0))
                run_len = k2
            else:
                dq, dr = q0 - int(aq[i - 1]), r0 - int(ar[i - 1])
                if dq == dr and dq <= k2:
                    run_len += dq
                    continue
                cut = max(0, k2 - dq, k2 - dr)
                eff = run_len - cut
                if eff > 0:
                    parts.append(('cig', [[eff, cg.EQ]]))
                sq0 = int(aq[i - 1]) + k2 - cut
                sr0 = int(ar[i - 1]) + k2 - cut
                self._add_segment(sq[sq0:q0], sr[sr0:r0], parts, segments,
                                  depth + 1,
                                  _sub_desc(qd, sq0, q0), _sub_desc(rd, sr0, r0))
                run_len = k2
        if run_len > 0:
            parts.append(('cig', [[run_len, cg.EQ]]))
        self._add_segment(sq[int(aq[-1]) + k2:], sr[int(ar[-1]) + k2:],
                          parts, segments, depth + 1,
                          _sub_desc(qd, int(aq[-1]) + k2, len(sq)),
                          _sub_desc(rd, int(ar[-1]) + k2, len(sr)))
        return True

    # ------------------------------------------------------------ DP batching

    def _run_segments(self, segments, resident=None, base_map=None,
                      rc_map=None):
        """Bucket DP jobs into padded classes and run batched kernel calls
        on the aligner's ladder (see the module docstring)."""
        accel = self.ladder == 'accel'
        band = 'wave' if accel else 'row'
        buckets = collections.defaultdict(list)
        for si, seg in enumerate(segments):
            if seg.kind == 'break':
                continue
            m, n = len(seg.q), len(seg.r)
            if not accel:
                buckets[_cpu_bucket(m, n)].append((si, False))
                continue
            # Segments run transposed when the query side is longer: global
            # DP is symmetric under (q<->r, I<->D), the DP is sequential
            # over rows, and rows = the shorter side minimizes its depth.
            # The transpose is a per-ITEM flag, not a bucket key — both
            # directions share a launch.
            t = m > n
            a, b = (n, m) if t else (m, n)
            buckets[_accel_bucket(a, b)].append((si, t))

        if accel:
            # Fold classes whose item count is far below their batch cap
            # into a wider neighbor (full width stays exact).
            buckets = _coalesce_buckets(buckets)

        def batch_pad(batch, n_items):
            if not accel:
                # CPU ladder: the batch padded up to a power of 4 (>= 8).
                b_pad = 8
                while b_pad < n_items:
                    b_pad *= 4
                return min(batch, b_pad)
            # pow2-down to >= 50% batch fill (floor 8): batch padding must
            # not reintroduce the padded cells the fine classes removed.
            b = batch
            while b >= 2 * max(n_items, 4) and b > 8:
                b //= 2
            return max(b, 8)

        def shape_batch(m_b, width_b, n_b=None):
            if not accel:
                return _cpu_shape_batch(m_b, width_b)
            return _shape_batch(m_b, width_b, n_b, self.device.type)

        # Device-resident sources (accelerator ladder): every host array the
        # segments slice is uploaded ONCE; launches carry only (offset, len,
        # flags) descriptors and the padded windows are gathered on the
        # device.
        if accel and resident is None:
            with spans.span('align.resident'):
                resident, base_map = _build_resident(segments, self.dp.devices)

        def locate(d):
            """Descriptor -> (resident_offset, len, gather_flags) or None.

            Windows of a reverse-complement source remap onto its forward
            buffer span: src_rc[off:off+ln] read forward equals the forward
            window at L-off-ln gathered reversed+complemented; reading it
            backwards cancels the reversal (complement only)."""
            src, off, ln, rev = d
            base = base_map.get(id(src))
            if base is not None:
                return (base + off, ln, 1 if rev else 0)
            rc = rc_map.get(id(src)) if rc_map else None
            if rc is None:
                return None
            fwd_base, src_len = rc
            return (fwd_base + src_len - off - ln, ln, 2 | (0 if rev else 1))

        def launch_chunk(chunk, width_b, m_b, n_b, pad_batch):
            """chunk: list of (segment_index, transposed) entries."""
            if resident is not None:
                items = []
                for i, t in chunk:
                    seg = segments[i]
                    qd, rd = seg.qdesc, seg.rdesc
                    if qd is None or rd is None:
                        items = None
                        break
                    if t:
                        qd, rd = rd, qd
                    ql = locate(qd)
                    rl = locate(rd)
                    if ql is None or rl is None:
                        items = None
                        break
                    items.append(ql + rl)
                if items is not None:
                    return self.dp.align_batch_refs_async(
                        items, width=width_b, pad_to=(m_b, n_b),
                        pad_batch=pad_batch, resident=resident, band=band)
            pairs = [(segments[i].r, segments[i].q) if t
                     else (segments[i].q, segments[i].r) for i, t in chunk]
            return self.dp.align_batch_async(
                pairs, width=width_b, pad_to=(m_b, n_b), pad_batch=pad_batch,
                band=band)

        # Two-phase: launch every bucket first, then collect — transfers
        # overlap later launches.
        launches = []
        for (m_b, n_b, width_b), entries in sorted(buckets.items()):
            # Batch cap per shape, sized so in-flight DP state stays bounded.
            batch = shape_batch(m_b, width_b, n_b)
            for lo in range(0, len(entries), batch):
                chunk = entries[lo:lo + batch]
                handle = launch_chunk(chunk, width_b, m_b, n_b,
                                      batch_pad(batch, len(chunk)))
                launches.append((chunk, handle))

        retry = []
        all_results = _resolve_handles([h for _, h in launches])
        for (chunk, handle), results in zip(launches, all_results):
            for (i, t), res in zip(chunk, results):
                if res is None:
                    retry.append(i)
                else:
                    segments[i].result = _swap_ins_del(res) if t else res
        if retry:
            # Band-escaping paths (e.g. opposing gaps) re-run at full width,
            # grouped into the same canonical classes (width = n_b + 1). On
            # the accelerator ladder, classes too large for the full-width
            # kernel (see _FULL_CELLS_MAX) become record breaks instead: the
            # path wandered >2k off-diagonal through a multi-kb block, which
            # reference aligners also split. The CPU ladder (as the
            # reference's CPU branch) retries every escape at full width.
            regroup = collections.defaultdict(list)
            for i in retry:
                seg = segments[i]
                m, n = len(seg.q), len(seg.r)
                t = accel and m > n
                if t:
                    m, n = n, m
                if accel:
                    m_b = _bucket_ladder(m)
                    n_b = _bucket_ladder(n)
                    if m_b * (n_b + 1) > _FULL_CELLS_MAX:
                        segments[i].kind = 'break'
                        continue
                else:
                    m_b = _bucket_pow2(m, lo=16)
                    n_b = _bucket_pow2(n, lo=16)
                regroup[(m_b, n_b)].append((i, t))
            # Two-phase like the main pass: launch every retry class, then
            # resolve together.
            retry_launches = []
            for (m_b, n_b), entries in sorted(regroup.items()):
                batch = shape_batch(m_b, n_b + 1)
                for lo in range(0, len(entries), batch):
                    chunk = entries[lo:lo + batch]
                    handle = launch_chunk(chunk, n_b + 1, m_b, n_b,
                                          batch_pad(batch, len(chunk)))
                    retry_launches.append((chunk, handle))
            for (chunk, handle), results in zip(
                    retry_launches,
                    _resolve_handles([h for _, h in retry_launches])):
                for (i, t), res in zip(chunk, results):
                    segments[i].result = _swap_ins_del(res) if t else res

        # Post-DP break detection: long segments that still aligned terribly.
        # Extension segments are exempt — their best-prefix trim already drops
        # whatever failed to align.
        for seg in segments:
            if seg.kind != 'dp' or seg.result is None:
                continue
            # Only balanced segments can break: an unbalanced segment is a clean
            # large indel and must stay inline (reference aligners inline these
            # within the -r bandwidth: rules/align.snakefile:188).
            if min(len(seg.q), len(seg.r)) >= _BREAK_MIN_LEN:
                lens, ops = seg.result
                matched = int(np.sum(lens[ops == cg.EQ]))
                if matched < _BREAK_MIN_IDENTITY * min(len(seg.q), len(seg.r)):
                    seg.kind = 'break'

    # ----------------------------------------------------------------- output

    def _emit_table(self, chain_meta, segments, hap):
        rows = []
        for meta in chain_meta:
            for rec in self._chain_records(meta, segments, hap):
                rows.append(rec)

        df = pd.DataFrame(rows, columns=ALIGN_COLUMNS) if rows else empty_align_table()
        df['INDEX'] = np.arange(df.shape[0])
        df = sort_align_table(df)
        return df

    def _chain_records(self, meta, segments, hap):
        """Emit one or more alignment records for a chain, splitting at break
        segments."""
        qlen = meta['qlen']
        is_rev = meta['is_rev']
        flag = 0x10 if is_rev else 0x0

        q_cur = meta['q_start']
        r_cur = meta['r_start']
        rec_q0 = q_cur
        rec_r0 = r_cur
        run_list = []  # [len, op] pairs accumulated for the open record

        records = []

        def close_record(q_end, r_end):
            if not run_list:
                return
            lens = np.fromiter((l for l, _ in run_list), dtype=np.int32,
                               count=len(run_list))
            ops = np.fromiter((o for _, o in run_list), dtype=np.int8,
                              count=len(run_list))
            lens, ops = cg.merge_adjacent(lens, ops)
            aligned_q = int(np.sum(lens * cg.CONSUMES_QRY[ops]))
            if aligned_q < _MIN_RECORD_ALIGNED:
                return
            # Strip leading/trailing I/D (a record must start and end aligned).
            i0, i1 = 0, len(ops)
            lead_q = lead_r = tail_q = tail_r = 0
            while i0 < i1 and ops[i0] in (cg.I, cg.D):
                if ops[i0] == cg.I:
                    lead_q += int(lens[i0])
                else:
                    lead_r += int(lens[i0])
                i0 += 1
            while i1 > i0 and ops[i1 - 1] in (cg.I, cg.D):
                if ops[i1 - 1] == cg.I:
                    tail_q += int(lens[i1 - 1])
                else:
                    tail_r += int(lens[i1 - 1])
                i1 -= 1
            lens, ops = lens[i0:i1], ops[i0:i1]
            if len(ops) == 0:
                return
            q0 = rec_q0 + lead_q
            r0 = rec_r0 + lead_r
            q1 = q_end - tail_q
            r1 = r_end - tail_r

            full_lens, full_ops = [], []
            if q0 > 0:
                full_lens.append(np.array([q0], dtype=np.int32))
                full_ops.append(np.array([cg.H], dtype=np.int8))
            full_lens.append(lens)
            full_ops.append(ops)
            if qlen - q1 > 0:
                full_lens.append(np.array([qlen - q1], dtype=np.int32))
                full_ops.append(np.array([cg.H], dtype=np.int8))
            lens_f = np.concatenate(full_lens)
            ops_f = np.concatenate(full_ops)

            qry_pos = qlen - q1 if is_rev else q0
            qry_end = qlen - q0 if is_rev else q1
            records.append((
                meta['chrom'], r0, r1,
                -1, meta['qry_name'],
                qry_pos, qry_end, qlen,
                'NA', 'NA', meta['mapq'],
                is_rev, f'0x{flag:04x}',
                hap, cg.to_string(lens_f, ops_f),
            ))

        for part in meta['parts']:
            if part[0] == 'cig':
                runs = part[1]
                run_list.extend(runs)
                for l, o in runs:
                    if cg.CONSUMES_QRY[o]:
                        q_cur += l
                    if cg.CONSUMES_REF[o]:
                        r_cur += l
            else:
                seg = segments[part[1]]
                if seg.kind == 'break':
                    close_record(q_cur, r_cur)
                    q_cur += len(seg.q)
                    r_cur += len(seg.r)
                    rec_q0, rec_r0 = q_cur, r_cur
                    run_list = []
                elif seg.kind in ('ext_l', 'ext_r'):
                    lens, ops = seg.result
                    run_list.extend(_trim_ext_runs(
                        lens, ops, self.scoring, seg.kind == 'ext_l',
                        len(seg.q), len(seg.r)))
                    q_cur += len(seg.q)
                    r_cur += len(seg.r)
                else:
                    lens, ops = seg.result
                    run_list.extend([int(l), int(o)] for l, o in zip(lens, ops))
                    q_cur += len(seg.q)
                    r_cur += len(seg.r)

        close_record(q_cur, r_cur)
        return records


def _lis_indices(arr):
    """Indices of a longest strictly-increasing subsequence (O(n log n))."""
    arr = np.asarray(arr)
    n = len(arr)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    tails = []          # last value of LIS of each length
    tails_idx = []      # index of that value
    parent = np.full(n, -1, dtype=np.int64)
    import bisect
    for i in range(n):
        v = arr[i]
        j = bisect.bisect_left(tails, v)
        if j == len(tails):
            tails.append(v)
            tails_idx.append(i)
        else:
            tails[j] = v
            tails_idx[j] = i
        if j > 0:
            parent[i] = tails_idx[j - 1]
    out = []
    i = tails_idx[-1]
    while i >= 0:
        out.append(i)
        i = parent[i]
    return np.array(out[::-1], dtype=np.int64)


def _coalesce_buckets(buckets):
    """Fold tiny full-width accelerator classes into close wider neighbors.

    Every launch costs a fixed round trip on latency-bound device links, so
    a class with a handful of items merges into a subsuming class when the
    padded per-item compute grows by at most 4x. The bound is deliberately
    tight: padded cells are NOT free (measured at bench scale: a 32x-blowup
    fold put 4280 small items into a 2049-wide class and padded compute
    became 90%+ of DP resolve time). Part-full classes above the item
    threshold launch their own pow4-down quantized batch instead (see
    batch_pad in _run_segments).
    """
    changed = True
    while changed:
        changed = False
        for key in sorted(buckets):
            m_b, n_b, width_b = key
            if width_b != n_b + 1:
                continue                      # banded classes stay put
            entries = buckets[key]
            if len(entries) >= 32:
                continue
            cells = m_b * width_b
            cands = [k for k in buckets
                     if k != key and k[2] == k[1] + 1
                     and k[0] >= m_b and k[1] >= n_b and k[0] <= 2048
                     and k[0] * k[2] <= 4 * cells]
            if not cands:
                continue
            tgt = min(cands, key=lambda k: (k[0], k[1]))
            buckets[tgt].extend(entries)
            del buckets[key]
            changed = True
            break
    return buckets


def _build_resident(segments, devices):
    """Concatenate every source array referenced by segment descriptors into
    one int8 buffer, copied to each of ``devices``.

    :return: ({device: tensor}, {id(src): base_offset}) or (None, None) when
        no segment carries descriptors.
    """
    srcs = []
    seen = set()
    for seg in segments:
        if seg.kind == 'break':
            continue
        for d in (seg.qdesc, seg.rdesc):
            if d is None or id(d[0]) in seen:
                continue
            seen.add(id(d[0]))
            srcs.append(d[0])
    return _build_resident_from(srcs, devices)


def _build_resident_from(arrays, devices):
    """Resident buffer from an explicit source-array list (see
    _build_resident): the plain int8 codes (0-4) of every distinct array,
    concatenated once on the host and copied to each of ``devices`` (the
    DP mesh's devices get replicas, as the reference replicates the buffer
    over its mesh). Gathers clamp into [0, total) and mask every position
    past a window, so no padding or guard region is needed.

    :return: ({device: int8 tensor}, {id(array): base offset})."""
    srcs = []
    base_map = {}
    total = 0
    for a in arrays:
        if a is None or id(a) in base_map:
            continue
        base_map[id(a)] = total
        srcs.append(a)
        total += len(a)
    if total >= 1 << 31:
        raise ValueError(f'a resident buffer of {total} bases: the gather descriptors '
                         f'(affine_dp.align_batch_refs_async) hold int32 offsets, so it '
                         f'must stay below 2^31 bases')
    if not srcs:
        return None, None
    with spans.span('align.upload', bases=total):
        buf = np.concatenate([np.asarray(a, dtype=np.uint8) for a in srcs]).view(np.int8)
        host = torch.from_numpy(buf)
        resident = {torch.device(d): host.to(d) for d in devices}
    return resident, base_map


def _swap_ins_del(res):
    """Map a transposed DP result back to the original frame (I <-> D)."""
    lens, ops = res
    swapped = np.where(ops == cg.I, cg.D,
                       np.where(ops == cg.D, cg.I, ops)).astype(np.int8)
    return lens, swapped


def _coalesce_spans(spans):
    """Merge overlapping/adjacent (lo, hi) spans."""
    if not spans:
        return []
    spans = sorted(spans)
    out = [list(spans[0])]
    for lo, hi in spans[1:]:
        if lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def _runs_from_positions(n, pos_list):
    """Equal-length direct comparison -> =/X run list from plain-int
    mismatch positions (zero numpy work; see _plan_chain's batched pass)."""
    runs = []
    prev = 0
    for i in pos_list:
        if i > prev:
            runs.append([i - prev, cg.EQ])
        if runs and runs[-1][1] == cg.X:
            runs[-1][0] += 1
        else:
            runs.append([1, cg.X])
        prev = i + 1
    if n > prev:
        runs.append([n - prev, cg.EQ])
    return runs


def _compare_runs_list(mism):
    """Equal-length direct comparison -> =/X run list from a mismatch mask
    (plain Python run pairs; the per-record array conversion happens once in
    _chain_records)."""
    n = len(mism)
    runs = []
    prev = 0
    for i in np.nonzero(mism)[0].tolist():
        if i > prev:
            runs.append([i - prev, cg.EQ])
        if runs and runs[-1][1] == cg.X:
            runs[-1][0] += 1
        else:
            runs.append([1, cg.X])
        prev = i + 1
    if n > prev:
        runs.append([n - prev, cg.EQ])
    return runs
