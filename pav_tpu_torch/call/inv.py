"""Inversion resolution: expand-and-rescan k-mer density scanning.

Parity with the reference resolver (pavlib/inv.py:149-455): start from a
flagged region, expand geometrically (directionally biased when one flank shows
reference-oriented k-mers), lift to the contig, compute orientation density,
and accept an inversion when forward flanks bracket a sufficiently long run of
strictly-inverted k-mers; outer breakpoints at the whole non-FWD span, inner at
the strict-REV span; size-proportion sanity check; inverted-duplication flank
annotation. The density scan is an in-process batched device computation
(pav_tpu_torch.call.density) rather than a subprocess per region.

Port of pav_tpu.call.inv: the same resolver with the density computed by the
torch port on the device the caller names (``device``).
"""

import numpy as np

from pav_tpu.constants import CALL_SOURCE_FLAG_DEN  # noqa: F401
from pav_tpu.regions import Region

from . import density as dens

INITIAL_EXPAND = 4000
EXPAND_FACTOR = 1.5
MAX_REGION_SIZE = 1200000
MIN_INFORMATIVE_KMERS = 2000
MIN_KMER_STATE_COUNT = 20
DENSITY_SMOOTH_FACTOR = 1
MIN_INV_KMER_RUN = 100
MIN_QRY_REF_PROP = 0.6
DEFAULT_MIN_EXP_COUNT = 1


class InvCall:
    """An accepted inversion with supporting regions (reference: pavlib/inv.py:54-118)."""

    def __init__(self, region_ref_outer, region_ref_inner,
                 region_tig_outer, region_tig_inner,
                 region_ref_discovery, region_tig_discovery,
                 region_flag, df):
        self.region_ref_outer = region_ref_outer
        self.region_ref_inner = region_ref_inner
        self.region_tig_outer = region_tig_outer
        self.region_tig_inner = region_tig_inner
        self.region_ref_discovery = region_ref_discovery
        self.region_tig_discovery = region_tig_discovery
        self.region_flag = region_flag
        self.df = df
        self.svlen = len(region_ref_outer)
        self.id = '{}-{}-INV-{}'.format(
            region_ref_outer.chrom, region_ref_outer.pos + 1, self.svlen)

    def __repr__(self):
        return self.id


def scan_for_inv(region_flag, ref_store, qry_store, align_lift, k_util,
                 n_index=None, max_region_size=None, log=None,
                 min_exp_count=DEFAULT_MIN_EXP_COUNT,
                 min_informative_kmers=MIN_INFORMATIVE_KMERS,
                 min_kmer_state_count=MIN_KMER_STATE_COUNT,
                 density_smooth_factor=DENSITY_SMOOTH_FACTOR,
                 min_inv_kmer_run=MIN_INV_KMER_RUN,
                 strict_parity=False, device=None):
    """Scan a flagged region for an inversion, expanding as necessary.

    :param region_flag: Flagged region to scan.
    :param ref_store: Reference SeqStore.
    :param qry_store: Haplotype contig SeqStore.
    :param align_lift: AlignLift over the trimmed alignment table.
    :param k_util: KmerUtil for the inversion k-mer size.
    :param n_index: Optional {chrom: IntervalIndex} of reference N gaps.
    :param max_region_size: Stop when the region grows beyond this (0 = no cap).

    :return: InvCall or None.
    """
    if min_exp_count is None:
        min_exp_count = DEFAULT_MIN_EXP_COUNT
    if max_region_size is None:
        max_region_size = MAX_REGION_SIZE

    _log(log, f'Scanning for inversions in flagged region: {region_flag}')

    ref_fai = ref_store.fai()
    region_ref = region_flag.copy()
    region_ref.expand(INITIAL_EXPAND, min_pos=0, max_end=ref_fai, shift=True)

    expansion_count = 0
    region_tig = None
    df = None
    state_rl = []

    while True:
        if 0 < max_region_size < len(region_ref):
            _log(log, f'Region size exceeds max: {region_ref} '
                      f'({len(region_ref)} > {max_region_size})')
            return None

        if n_index is not None and region_ref.chrom in n_index:
            if n_index[region_ref.chrom].any_overlap(region_ref.pos, region_ref.end):
                _log(log, f'Region overlaps N bases: {region_ref}')

        region_tig = align_lift.lift_region_to_qry(region_ref)
        if region_tig is None:
            _log(log, f'Could not lift reference region onto contigs: {region_ref}')
            return None

        expansion_count += 1
        _log(log, f'Scanning region: {region_ref}')

        try:
            ref_kmers = dens.ref_kmer_set(
                ref_store.fetch_region(region_ref, rev_compl=False), k_util)
        except dens.LowComplexityRegion as ex:
            _log(log, f'Low-complexity region, aborting: {region_ref}: {ex}')
            return None

        tig_codes = qry_store.fetch_region(region_tig)  # oriented by is_rev
        # Scan pass transfers only the smoothed state vector; full densities are
        # re-fetched once for the accepted region below.
        df = dens.get_smoothed_density(
            tig_codes, ref_kmers, k_util,
            min_informative_kmers=min_informative_kmers,
            density_smooth_factor=density_smooth_factor,
            min_state_count=min_kmer_state_count, with_density=False,
            device=device)

        if df.shape[0] == 0:
            _log(log, 'No informative reference k-mers in region')
            return None

        state_rl = dens.rl_encoder(df)
        condensed = [rec[0] for rec in state_rl]

        if (len(state_rl) == 1 and state_rl[0][0] in (0, -1)
                and expansion_count >= min_exp_count):
            _log(log, f'Found no inverted k-mer states after {expansion_count} expansion(s)')
            return None

        if len(condensed) > 2 and condensed[0] == 0 and condensed[-1] == 0:
            break  # flanked by reference-oriented sequence

        last_len = len(region_ref)
        expand_bp = int(len(region_ref) * EXPAND_FACTOR)
        if len(condensed) > 2 and condensed[0] == 0:
            balance = 0.25  # reference upstream: grow mostly downstream
        elif len(condensed) > 2 and condensed[-1] == 0:
            balance = 0.75
        else:
            balance = 0.5
        region_ref.expand(expand_bp, min_pos=0, max_end=ref_fai, shift=True,
                          balance=balance)
        if len(region_ref) == last_len:
            _log(log, 'Reached reference limits, cannot expand')
            return None

    # Characterize the found region.
    if not any(rec[0] == 2 for rec in state_rl):
        _log(log, 'No inverted states found')
        return None

    max_inv_run = max(rec[1] for rec in state_rl if rec[0] == 2)
    if max_inv_run < min_inv_kmer_run:
        _log(log, f'Longest strictly-inverted run ({max_inv_run}) below minimum '
                  f'({min_inv_kmer_run})')
        return None

    if state_rl[0][0] != 0 or state_rl[-1][0] != 0:
        raise RuntimeError(
            f'Found INV region not flanked by reference sequence (program bug): {region_ref}')

    # Re-fetch the density columns for the accepted region (artifact parity:
    # the per-inversion density table carries KERN_* values).
    df = dens.get_smoothed_density(
        qry_store.fetch_region(region_tig), ref_kmers, k_util,
        min_informative_kmers=min_informative_kmers,
        density_smooth_factor=density_smooth_factor,
        min_state_count=min_kmer_state_count, with_density=True,
        device=device)

    state_rl_inv = [rec for rec in state_rl if rec[0] == 2]
    k = k_util.k_size

    region_tig_outer = Region(
        region_tig.chrom,
        state_rl[1][2] + region_tig.pos,
        state_rl[-2][3] + region_tig.pos + k,
        is_rev=region_tig.is_rev)
    region_tig_inner = Region(
        region_tig.chrom,
        state_rl_inv[0][2] + region_tig.pos,
        state_rl_inv[-1][3] + region_tig.pos + k,
        is_rev=region_tig.is_rev)

    region_ref_outer = align_lift.lift_region_to_sub(region_tig_outer)
    if region_ref_outer is None and not strict_parity:
        # Deviation from the reference (which gives up here: inv.py:393-401):
        # when the aligner breaks exactly at the inversion boundary, the outer
        # breakpoints land in the inter-record query gap; recover them from the
        # gap's reference edges instead of dropping a confirmed inversion.
        region_ref_outer = _lift_outer_with_gap_edges(
            align_lift, region_tig_outer)
    if region_ref_outer is None:
        _log(log, f'Failed lifting outer INV region to reference: {region_tig_outer}')
        return None
    region_ref_inner = align_lift.lift_region_to_sub(region_tig_inner, gap=True)
    if region_ref_inner is None:
        region_ref_inner = region_ref_outer

    # Size proportion check (reference: pavlib/inv.py:414-436). When the
    # reference span comes out too short, the outer breakpoints usually landed
    # inside an insertion block with the paired deletion a few bases outside
    # the strict k-mer span (aligned-through inversions are represented as
    # adjacent I/D); retry with a 2k slack before giving up — a recall
    # improvement over the reference, which drops the call here.
    if len(region_ref_outer) < len(region_tig_outer) * MIN_QRY_REF_PROP:
        k_slack = 2 * k
        wide = Region(region_tig_outer.chrom,
                      max(region_tig_outer.pos - k_slack, 0),
                      region_tig_outer.end + k_slack,
                      is_rev=region_tig_outer.is_rev)
        region_ref_wide = None if strict_parity else align_lift.lift_region_to_sub(wide)
        if (region_ref_wide is not None
                and len(region_ref_wide) >= len(region_tig_outer) * MIN_QRY_REF_PROP):
            region_ref_outer = region_ref_wide
            region_tig_outer = wide
        else:
            _log(log, 'Reference region too short vs contig region')
            return None
    if len(region_tig_outer) < len(region_ref_outer) * MIN_QRY_REF_PROP:
        _log(log, 'Contig region too short vs reference region')
        return None

    df = annotate_inv_dup_mers(
        df, region_ref_outer, region_ref_inner, region_tig_outer,
        region_tig_inner, region_tig, ref_store, k_util)

    inv_call = InvCall(
        region_ref_outer, region_ref_inner,
        region_tig_outer, region_tig_inner,
        region_ref, region_tig, region_flag, df)
    _log(log, f'Found inversion: {inv_call}')
    return inv_call


def _lift_outer_with_gap_edges(align_lift, region_tig_outer):
    """Lift an outer INV region whose endpoints may fall in an alignment gap:
    a gapped start endpoint takes the gap's left reference edge, a gapped end
    endpoint the right edge."""
    lifted = align_lift.lift_to_sub(
        region_tig_outer.chrom, (region_tig_outer.pos, region_tig_outer.end),
        gap=True)
    spos, send = lifted
    if spos is None or send is None:
        return None
    if spos[0] != send[0]:
        return None
    # pos_min/pos_max of a gap lift are the flanking records' reference edges.
    start = spos[3] if spos[3] != spos[4] else spos[1]
    end = send[4] if send[3] != send[4] else send[1]
    if end <= start:
        return None
    return Region(spos[0], start, end, is_rev=False,
                  pos_aln_index=(spos[5],), end_aln_index=(send[5],))


def annotate_inv_dup_mers(df, region_ref_outer, region_ref_inner,
                          region_tig_outer, region_tig_inner,
                          region_tig_discovery, ref_store, k_util):
    """Mark flank k-mers belonging strictly to the opposite inverted-duplication
    copy (reference: pavlib/inv.py:457-561). Adds FLANK ('' / UP / DN) and MATCH
    ('' / SAME / OTHER / NaN)."""
    import pandas as pd
    from pav_tpu import kmer as km

    region_dup_ref_up = Region(region_ref_outer.chrom, region_ref_outer.pos,
                               region_ref_inner.pos)
    region_dup_ref_dn = Region(region_ref_outer.chrom, region_ref_inner.end,
                               region_ref_outer.end)
    region_dup_tig_up = Region(region_tig_outer.chrom, region_tig_outer.pos,
                               region_tig_inner.pos)
    region_dup_tig_dn = Region(region_tig_outer.chrom, region_tig_inner.end,
                               region_tig_outer.end)

    k = k_util.k_size

    def canon_set(region):
        if len(region) < k:
            return np.zeros(0, dtype=np.uint64)
        codes = ref_store.fetch_region(region, rev_compl=False)
        ks = km.kmer_set(codes, k)
        return np.unique(k_util.canonical_complement(ks)) if len(ks) else ks

    ref_set_up = canon_set(region_dup_ref_up)
    ref_set_dn = canon_set(region_dup_ref_dn)

    qry_index = df['INDEX'].to_numpy() + region_tig_discovery.pos
    kmers = df['KMER'].to_numpy().astype(np.uint64)

    flank = np.full(df.shape[0], '', dtype=object)
    flank[(qry_index >= region_dup_tig_up.pos)
          & (qry_index < region_dup_tig_up.end - k)] = 'UP'
    flank[(qry_index >= region_dup_tig_dn.pos)
          & (qry_index < region_dup_tig_dn.end - k)] = 'DN'

    match = np.full(df.shape[0], '', dtype=object)
    for side, same_set, other_set in (('UP', ref_set_up, ref_set_dn),
                                      ('DN', ref_set_dn, ref_set_up)):
        sel = flank == side
        if not sel.any():
            continue
        in_same = km.in_sorted(same_set, kmers[sel])
        in_other = km.in_sorted(other_set, kmers[sel])
        # KMER_LOC_STATE (reference: pavlib/inv.py:46-51): SAME only, OTHER only,
        # both or neither -> NA.
        vals = np.full(sel.sum(), np.nan, dtype=object)
        vals[in_same & ~in_other] = 'SAME'
        vals[~in_same & in_other] = 'OTHER'
        match[sel] = vals

    df = df.copy()
    df['FLANK'] = flank
    df['MATCH'] = match
    df.loc[df['MATCH'].isin(['']), 'MATCH'] = np.nan
    return df


def _log(log, message):
    if log is None:
        return
    log.write(message)
    log.write('\n')
    log.flush()
