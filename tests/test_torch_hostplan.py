"""The aligner's native host path (``align/aligner/hostplan.py`` over
``hostsrc/aligner.cpp``) against the Python planner and record assembly of
``align/aligner/core.py``, which it replaces where its library builds.

Each scenario is a contig on a two-chromosome reference with its chains
given as anchors, drawn from a seed so that the planner reaches every
branch: the equal-length fast path, pure insertions and deletions,
mismatch-dense breaks of at least ``_BREAK_MIN_LEN``, balanced and
unbalanced segments refined along unique 21-mers (the LIS step), DP
segments, a chain on another chromosome that loses the selection and sets
the primary's MAPQ, a reverse chain over an inverted core that only the
second pass accepts, and end extensions clipped by the contig's ends, the
reference's ends and ``_MAX_EXTEND``; each scenario is also run on the
contig's reverse complement, where every chain changes strand. The native
plan must equal the Python one column for column (chains, parts,
segments and their windows), its records must equal ``_chain_records``'
under the same DP results (a record split at breaks, one dropped under
``_MIN_RECORD_ALIGNED``, a post-DP break), and ``align_store`` on either
path must give the same table on both ladders. A library that fails to
build leaves the Python path, with the same table and ``on=python``.
"""

import ctypes

import numpy as np
import pandas as pd
import pytest
import torch

from pav_tpu_torch import seqcodec, spans
from pav_tpu_torch.align import cigar as cg
from pav_tpu_torch.align.aligner import core, hostplan
from pav_tpu_torch.align.aligner.chain import ChainSet
from pav_tpu_torch.io.fasta import SeqStore

from helpers import random_seq

K = 19
KINDS = {'dp': hostplan.DP, 'break': hostplan.BREAK, 'ext_l': hostplan.EXT_L,
         'ext_r': hostplan.EXT_R}


@pytest.fixture(scope='module')
def handle():
    h = hostplan.lib()
    assert h is not None, 'the planner library did not build'
    return h


def _mutated(codes, rng, frac):
    out = codes.copy()
    hit = rng.random(len(out)) < frac
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return out


def _scenario(seed, head=(2000, 7000), tail=(400, 6000)):
    """(ref {name: codes}, contig, ChainSet) of one seed (module docstring);
    ``head`` and ``tail`` bound the unanchored ends' lengths."""
    rng = np.random.default_rng(seed)
    chr1, chr2 = random_seq(60000, rng), random_seq(20000, rng)
    head = random_seq(int(rng.integers(*head)), rng)
    pieces, primary = [head], []
    at = {'q': len(head), 'r': int(rng.integers(100, 400))}
    r_first = at['r']

    def match(n):
        # Exact copy, an anchor every 10 bases; n = 10m + 19 puts the last
        # anchor flush with the block's end (pure gaps follow).
        for j in range(0, n - K + 1, 10):
            primary.append((at['q'] + j, at['r'] + j))
        pieces.append(chr1[at['r']:at['r'] + n].copy())
        at['q'] += n
        at['r'] += n

    def gap(qseq, rn):
        pieces.append(qseq)
        at['q'] += len(qseq)
        at['r'] += rn

    def ref_here(n):
        return chr1[at['r']:at['r'] + n]

    match(209)
    for _ in range(int(rng.integers(2, 5))):         # fast path: 1-2 mismatches
        n = int(rng.integers(1, 4))
        gap(_mutated(ref_here(n), rng, 0.7), n)
        match(int(rng.integers(8, 20)) * 10 + 19)
    gap(random_seq(int(rng.integers(1, 60)), rng), 0)  # pure insertion
    match(209)
    gap(np.zeros(0, np.uint8), int(rng.integers(1, 60)))  # pure deletion
    match(209)
    gap(random_seq(600, rng), 600)                   # mismatch-dense: a break
    match(209)
    gap(random_seq(500, rng), 500)                   # an island of < 50 bases
    match(29)                                        # between two breaks
    gap(random_seq(500, rng), 500)
    match(209)
    n = int(rng.integers(1000, 1600))                # refined, unbalanced
    region = _mutated(ref_here(n), rng, 0.08)
    ins = int(rng.integers(20, 90))
    gap(np.concatenate([region[:n // 2], random_seq(ins, rng), region[n // 2:]]), n)
    match(309)
    n = int(rng.integers(800, 1300))                 # refined, balanced
    gap(_mutated(ref_here(n), rng, 0.1), n)
    match(309)
    gap(random_seq(450, rng), 500)                   # DP, min side >= 400
    match(209)
    small = _mutated(ref_here(43), rng, 0.05)
    gap(np.concatenate([small[:20], small[25:]]), 43)  # DP with a deletion
    match(2009)
    core_q, core_r = at['q'], at['r']                # inverted core: a break,
    gap(seqcodec.revcomp(ref_here(3000)), 3000)      # then pass 2's chain
    match(2009)
    tail_r = len(chr1) - int(rng.integers(50, 300))
    match(tail_r - at['r'])                          # to near the ref's end
    pieces.append(random_seq(int(rng.integers(*tail)), rng))
    contig = np.concatenate(pieces)
    qlen = len(contig)

    p_q = np.array([q for q, _ in primary], dtype=np.int64)
    p_r = np.array([r for _, r in primary], dtype=np.int64)
    inv = np.arange(0, 3000 - K + 1, 10, dtype=np.int64)
    lo, hi = len(head) + 200, core_q
    rival = np.sort(rng.choice(np.arange(lo, hi), 40, replace=False))
    extra = np.arange(100, len(head) - 300, 10, dtype=np.int64)
    chains = [
        # chrom, rev, qpos, rpos, score
        (0, False, p_q, p_r, 5000.0),
        (1, False, rival, np.sort(rng.choice(20000 - K, 40, replace=False)), 3000.0),
        (0, True, qlen - core_q - 3000 + inv, core_r + inv, 1500.0),
    ]
    if seed % 2 == 0:
        # A second primary chain ahead of the first, tied with the rival:
        # it takes the left extension. Odd seeds extend the first chain,
        # clipped by the reference's start.
        chains.append((1, False, extra, 500 + extra - extra[0], 3000.0))
    assert r_first < 400
    return {'chr1': chr1, 'chr2': chr2}, contig, _chain_set(chains)


def _chain_set(chains):
    chains = sorted(chains, key=lambda c: -c[4])
    lens = [len(c[2]) for c in chains]
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return ChainSet(off, np.concatenate([c[2] for c in chains]),
                    np.concatenate([c[3] for c in chains]),
                    np.array([c[0] for c in chains], dtype=np.int64),
                    np.array([c[1] for c in chains], dtype=bool),
                    np.array([c[4] for c in chains], dtype=np.float64))


def _flipped(ref, contig, chains):
    """The scenario on the contig's reverse complement: every chain on the
    other strand, its anchors unchanged."""
    return ref, seqcodec.revcomp(contig), ChainSet(chains.off, chains.qpos, chains.rpos,
                                                     chains.chrom, ~chains.rev, chains.score)


def _scenarios():
    for seed in (0, 1, 2, 3):
        yield pytest.param(seed, False, id=f'seed{seed}-fwd')
        yield pytest.param(seed, True, id=f'seed{seed}-rev')


def _setup(seed, flip, ladder='accel', **ends):
    ref, contig, chains = _scenario(seed, **ends)
    if flip:
        ref, contig, chains = _flipped(ref, contig, chains)
    al = core.Aligner(SeqStore(ref), {}, device='cpu', ladder=ladder)
    return al, contig, chains


def _python_plan(al, contig, chains):
    rc = seqcodec.revcomp(contig)
    metas, segments = al._plan_python('tig', len(contig), chains.chains(),
                                      lambda is_rev: rc if is_rev else contig)
    return metas, segments, rc


def _native_plan(handle, al, contig, chains):
    rc = seqcodec.revcomp(contig) if chains.rev.any() else None
    plan = hostplan.plan_contig(handle, contig, rc, al._host_refs(), chains, al.k,
                                core._native_params())
    return hostplan.Plan.join([plan]), rc


def _window(src, off, ln, rev):
    w = src[off:off + ln]
    return w[::-1] if rev else w


@pytest.mark.parametrize('seed,flip', list(_scenarios()))
def test_native_plan_equals_python(handle, seed, flip):
    al, contig, chains = _setup(seed, flip)
    metas, segments, rc = _python_plan(al, contig, chains)
    plan, _ = _native_plan(handle, al, contig, chains)
    refs = al._host_refs()

    assert len(plan.chains) == len(metas)
    names = al.index.chrom_names
    for row, meta in zip(plan.chains, metas):
        got = dict(zip(hostplan.CHAIN_COLS, row.tolist()))
        assert (names[got['chrom']], bool(got['rev']), got['q_start'], got['r_start'],
                got['q_end'], got['r_end'], got['mapq']) == (
            meta['chrom'], meta['is_rev'], meta['q_start'], meta['r_start'],
            meta['q_end'], meta['r_end'], meta['mapq'])
        want = []
        for part in meta['parts']:
            if part[0] == 'cig':
                want.extend((int(n), int(o)) for n, o in part[1])
            else:
                want.append((part[1], hostplan.SEG))
        lo = got['part0']
        parts = list(zip(plan.part_len[lo:lo + got['n_parts']].tolist(),
                         plan.part_op[lo:lo + got['n_parts']].tolist()))
        assert parts == want

    assert len(plan.segs) == len(segments)
    for row, seg in zip(plan.segs, segments):
        s = dict(zip(hostplan.SEG_COLS, row.tolist()))
        assert s['kind'] == KINDS[seg.kind]
        q = _window(rc if s['qsrc'] else contig, s['qoff'], s['qlen'], s['qrev'])
        r = _window(refs[s['rsrc']], s['roff'], s['rlen'], s['rrev'])
        assert np.array_equal(q, seg.q) and np.array_equal(r, seg.r)
        src, off, ln, rev = seg.qdesc
        assert (src is rc, off, ln, rev) == (bool(s['qsrc']), s['qoff'], s['qlen'],
                                             bool(s['qrev']))
        src, off, ln, rev = seg.rdesc
        assert (src is refs[s['rsrc']] or np.shares_memory(src, refs[s['rsrc']]),
                off, ln, rev) == (True, s['roff'], s['rlen'], bool(s['rrev']))

    # The Python plan in columns, as align_store hands it to the DP, is
    # the native plan.
    columns = hostplan.Plan.join([al._plan_columns(metas, segments, contig)])
    for name in ('chains', 'part_len', 'part_op', 'segs', 'contig', 'seg_contig'):
        np.testing.assert_array_equal(getattr(columns, name), getattr(plan, name))

    # Every branch the scenario is built to reach was reached.
    kinds = [seg.kind for seg in segments]
    assert {'dp', 'break', 'ext_l', 'ext_r'} <= set(kinds)
    assert kinds.count('break') >= 4
    ops = set(plan.part_op.tolist())
    assert {cg.EQ, cg.X, cg.I, cg.D} <= ops
    assert sum(m['is_rev'] != flip for m in metas) == 1, 'pass 2 takes the inverted core'
    assert [m['mapq'] for m in metas][0] < 60
    # Refinement split every segment of 512 or more on both sides that did
    # not break (the refined regions are 800-1600 bases).
    assert not [seg for seg in segments
                if seg.kind == 'dp' and min(len(seg.q), len(seg.r)) >= 512]


def _fake_results(segments, rng):
    """A DP result for every DP and extension segment: runs consuming its
    windows, mostly X for one long segment (a post-DP break)."""
    results = {}
    for i, seg in enumerate(segments):
        if seg.kind == 'break':
            continue
        lq, lr = len(seg.q), len(seg.r)
        common = min(lq, lr)
        if seg.kind == 'dp' and common >= core._BREAK_MIN_LEN:
            runs = [(common, cg.X)]
        else:
            cuts = (np.sort(rng.choice(np.arange(1, common), min(6, common - 1), replace=False))
                    if common > 1 else np.zeros(0, np.int64))
            edges = np.concatenate([[0], cuts, [common]])
            runs = [(int(b - a), cg.X if j % 3 == 1 else cg.EQ)
                    for j, (a, b) in enumerate(zip(edges[:-1], edges[1:]))]
        if lq != lr:
            runs.insert(int(rng.integers(0, len(runs) + 1)),
                        (abs(lq - lr), cg.I if lq > lr else cg.D))
        runs = [(n, o) for n, o in runs if n > 0]
        results[i] = (np.array([n for n, _ in runs], dtype=np.int32),
                      np.array([o for _, o in runs], dtype=np.int8))
    return results


@pytest.mark.parametrize('seed,flip', list(_scenarios()))
def test_native_records_equal_chain_records(handle, seed, flip):
    al, contig, chains = _setup(seed, flip)
    metas, segments, _ = _python_plan(al, contig, chains)
    plan, _ = _native_plan(handle, al, contig, chains)
    results = _fake_results(segments, np.random.default_rng(seed + 100))
    for i, res in results.items():
        segments[i].result = res
    breaks = sum(seg.kind == 'break' for seg in segments)
    core._post_dp_breaks(segments)
    assert sum(seg.kind == 'break' for seg in segments) > breaks, 'no post-DP break'
    want = al._emit_table(metas, segments, 'h1')

    ids = np.array(sorted(results), dtype=np.int64)
    counts = np.array([len(results[i][0]) for i in ids], dtype=np.int64)
    res_off = np.zeros(len(plan.segs), dtype=np.int64)
    res_n = np.full(len(plan.segs), -1, dtype=np.int64)
    res_off[ids] = np.cumsum(counts) - counts
    res_n[ids] = counts
    lens = np.concatenate([results[i][0] for i in ids])
    ops = np.concatenate([results[i][1] for i in ids])
    got = al._emit_columns(handle, plan, plan.col('kind').copy(), res_off, res_n, lens, ops,
                           ['tig'], [contig], 'h1', core._native_params())
    pd.testing.assert_frame_equal(got, want)
    # The Python path's hand-back of the same columns to _emit_table.
    fresh = _python_plan(al, contig, chains)[:2]
    pd.testing.assert_frame_equal(
        al._emit_python([fresh], plan.col('kind').copy(), res_off, res_n, lens, ops, 'h1'),
        want)
    # The primary chain splits at its breaks; the island between two breaks
    # is dropped under _MIN_RECORD_ALIGNED.
    assert want.shape[0] >= 5
    cigars = want['CIGAR'].map(cg.parse)
    assert all(int(np.sum(l * cg.CONSUMES_QRY[o])) >= core._MIN_RECORD_ALIGNED
               for l, o in cigars)


@pytest.fixture
def one_torch_thread():
    """The plain DP versions on one thread: the suite's workers share the
    host's cores, and many threads a worker crowd out each other's small
    steps."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('ladder', ['accel', 'cpu'])
@pytest.mark.parametrize('seed,flip', [(0, False), (1, True)])
def test_align_store_paths_agree(monkeypatch, one_torch_thread, ladder, seed, flip):
    """align_store with the scenario's chains on either path, the DP run
    for real: the same table, and the spans say which path ran."""
    al, contig, chains = _setup(seed, flip, ladder, head=(800, 1000), tail=(400, 600))
    monkeypatch.setattr(core, 'find_chains', lambda *a, columns=False, **kw:
                        chains if columns else chains.chains())
    store = SeqStore({'tig': contig})
    tables, on = {}, {}
    for path in ('native', 'python'):
        if path == 'python':
            monkeypatch.setattr(hostplan, '_STATE', {'lib': None})
        rec = spans.Recorder()
        with rec.active():
            tables[path] = al.align_store(store, 'h1')
        on[path] = {s.name: s.counts.get('on') for s in rec.records
                    if s.name in ('align.plan_contig', 'align.emit')}
    pd.testing.assert_frame_equal(tables['native'], tables['python'])
    assert tables['native'].shape[0] >= 3
    assert on == {p: {'align.plan_contig': p, 'align.emit': p} for p in on}


def test_a_failed_build_falls_back_to_python(tmp_path, monkeypatch):
    """A planner source that does not compile leaves ``lib()`` None, and
    align_store runs the Python planner: the same table as the native path,
    its spans ``on=python``."""
    from helpers import Mutator
    rng = np.random.default_rng(5)
    ref = random_seq(120000, rng)
    mut = Mutator(ref)
    mut.snv(20000, rng=rng)
    mut.ins(50000, random_seq(300, rng))
    mut.dele(80000, 200)
    hap = mut.finish()
    al = core.Aligner(SeqStore({'chr1': ref}), {'aligner_min_chain_score': 500},
                      device='cpu', ladder='accel')
    store = SeqStore({'tig': hap[1000:110000].copy()})
    want = al.align_store(store, 'h1')

    broken = tmp_path / 'broken.cpp'
    broken.write_text('not C++\n')
    monkeypatch.setattr(hostplan, '_SRC', str(broken))
    monkeypatch.setattr(hostplan, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(hostplan, '_STATE', {})
    monkeypatch.setattr(hostplan, 'BUILD_INFO', {})
    rec = spans.Recorder()
    with rec.active(), pytest.warns(UserWarning, match='Python planner runs'):
        got = al.align_store(store, 'h1')
    assert hostplan.lib() is None
    assert 'broken.cpp' in hostplan.BUILD_INFO['error'], 'the compiler\'s output is kept'
    pd.testing.assert_frame_equal(got, want)
    assert want.shape[0] >= 1
    ran = [s.counts.get('on') for s in rec.records
           if s.name in ('align.plan_contig', 'align.emit')]
    assert ran == ['python', 'python']


def test_library_is_loaded_without_holding_the_lock(handle):
    """``CDLL`` (not ``PyDLL``): ctypes drops the interpreter lock for each
    call, so planning threads run at once."""
    assert isinstance(handle, ctypes.CDLL) and not isinstance(handle, ctypes.PyDLL)


def _accel_class(m, n):
    """The accelerator ladder's class of one pair (m <= n), step by step as
    the reference writes it."""
    def up(x):
        for v in core._ACCEL_LADDER:
            if x <= v:
                return v
        return core._ACCEL_LADDER[-1]
    m_b, n_b = up(m), up(n)
    if max(m_b, n_b) <= 2048 or (m_b != n_b and m_b * (n_b + 1) <= core._FULL_CELLS_MAX):
        return m_b, n_b, n_b + 1
    return m_b, n_b, 512 if 2 * abs(m - n) + core._MIN_WIDTH <= 513 else 2048


def _cpu_class(m, n):
    """The CPU ladder's class of one pair, step by step as the reference
    writes it."""
    def pow2(x, lo, hi=1 << 15):
        v = lo
        while v < x and v < hi:
            v <<= 1
        return v
    m_b, n_b = pow2(m, 16), pow2(n, 16)
    if max(m_b, n_b) <= 256:
        return m_b, n_b, min(pow2(2 * abs(m - n) + 17, 16) + 1, n_b + 1)
    width = min(2 * abs(m - n) + core._MIN_WIDTH, n + 1)
    return m_b, n_b, min(pow2(width, 256) + 1, n_b + 1)


PAIRS = [(1, 1), (16, 17), (17, 16), (300, 300), (2048, 2049), (3000, 3100), (3000, 3900),
         (16, 30000), (9000, 9000), (40000, 40000), (255, 256), (257, 900)]


@pytest.mark.parametrize('m,n', PAIRS)
def test_class_columns_equal_the_scalar_classes(m, n):
    """The vectorised classes of the DP hand-off equal the ladders written
    out pair by pair, on their own and among all the pairs at once."""
    a, b = min(m, n), max(m, n)
    assert core._accel_bucket(a, b) == _accel_class(a, b)
    assert core._cpu_bucket(m, n) == _cpu_class(m, n)
    ms = np.array([p[0] for p in PAIRS] + [m])
    ns = np.array([p[1] for p in PAIRS] + [n])
    lo, hi = np.minimum(ms, ns), np.maximum(ms, ns)
    assert [tuple(int(v[i]) for v in core._accel_bucket_cols(lo, hi))
            for i in range(len(ms))] == [_accel_class(x, y) for x, y in zip(lo, hi)]
    assert [tuple(int(v[i]) for v in core._cpu_bucket_cols(ms, ns))
            for i in range(len(ms))] == [_cpu_class(x, y) for x, y in zip(ms, ns)]
