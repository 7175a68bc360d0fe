"""The engine: one in-memory pipeline replacing the reference's Snakemake DAG.

Stage graph (reference call stack: SURVEY.md §3.1), executed per sample:

  ingest -> align (native aligner) -> trim-qry -> trim-qryref -> depth
         -> cigar calls (+TRIM filter vs trimmed bounds)
         -> large-SV scan -> inversion flag + scan
         -> integrate + callable regions (per haplotype)
         -> haplotype merge -> VCF

Data flows in memory as DataFrames/SeqStores; artifacts are written to the run
directory at stage boundaries for inspection and resume (the reference's
file-target checkpointing, SURVEY.md §5-checkpoint, kept only at the edges).

Port of pav_tpu.pipeline: the same stages and artifacts, with the aligner and
the inversion density on the torch port and one explicit ``torch.device``
for the run (config key ``device``, default ``cuda``); config key
``mesh_devices`` > 1 splits the aligner's DP launches over that many devices
(``parallel.mesh``).
"""

import contextlib
import io as _io
import os
import sys

import numpy as np
import pandas as pd
import torch

from . import constants, seqcodec, spans, vcf as vcf_mod
from .align.aligner import Aligner
from .align.lift import AlignLift
from .align.table import depth_table, finalize_align_table
from .align.trim import trim_alignments
from .assembly_table import (get_filter_spec, get_hap_list, load_filter_regions,
                             load_haplotype_seqs, read_assembly_table,
                             get_asm_config_override)
from .call import inv_flag
from .call.cigar_calls import make_insdel_snv_calls
from .call.integrate import callable_regions, get_merge_params, integrate_sources, merge_haplotypes
from .config import Config, load_config, override_config
from .io.fasta import SeqStore
from .kmer import KmerUtil
from .regions import Region
from .util import build_interval_index_by_chrom
from .call import inv as inv_mod, largesv
from .device import resolve_device
from .ops.affine_dp import BandedAligner
from .parallel import pools
from .parallel.mesh import make_mesh


_HAP_ARTIFACTS = (
    ('align_trim-none', 'align_none'),
    ('align_trim-qry', 'align_qry'),
    ('align_trim-qryref', 'align_qryref'),
    ('depth_qry', 'depth_qry'),
    ('snv_snv', 'df_snv'), ('svindel_insdel', 'df_insdel'),
    ('lg_ins', 'df_lg_ins'), ('lg_del', 'df_lg_del'),
    ('lg_inv', 'df_lg_inv'), ('inv_flag', 'df_flag'),
    ('sv_inv', 'df_inv'), ('callable', 'callable'),
)


class HaplotypeResult:
    """Per-haplotype intermediate artifacts."""

    def __init__(self):
        self.align_none = None
        self.align_qry = None
        self.align_qryref = None
        self.depth_qry = None
        self.df_snv = None
        self.df_insdel = None
        self.df_lg_ins = None
        self.df_lg_del = None
        self.df_lg_inv = None
        self.df_inv = None
        self.df_flag = None
        self.callable = None
        self.integrated = None  # {varsvtype: (pass, fail_nonredundant)}
        self.fail_redundant = None  # {varsvtype: redundant FAIL calls}
        self.inv_calls = []  # accepted InvCall objects (figures + density tables)


class Pipeline:
    """End-to-end variant calling engine for one reference + assembly set."""

    def __init__(self, ref, config=None, run_dir=None, log=None, device=None,
                 ladder=None, mesh=None):
        """
        :param ref: Reference SeqStore or FASTA path.
        :param config: Config/dict of parameters (see pav_tpu.config.DEFAULTS).
        :param run_dir: Optional artifact directory.
        :param device: torch device name or object; None takes the config key
            ``device`` (default ``cuda``).
        :param ladder: the aligner's DP class ladder, ``'cpu'`` or
            ``'accel'``; None picks by device as the reference picks by
            backend (``align.aligner.core.resolve_ladder``).
        :param mesh: a list of devices to shard the DP launches over (a
            device may repeat), the one way to name the devices; config
            ``mesh_devices`` only counts them (``make_mesh(mesh_devices,
            device)``). Giving both raises.
        """
        self.config = config if isinstance(config, Config) else load_config(config)
        self.device = resolve_device(
            device if device is not None else self.config.get('device'))
        self.ladder = ladder
        # mesh_devices > 1 shards DP batches over a device mesh (contig-batch
        # data parallelism); make_mesh raises when the devices are missing.
        n_mesh = int(self.config.get('mesh_devices', 0) or 0)
        if mesh is not None:
            if n_mesh > 1:
                raise ValueError('give the mesh either as mesh= or as config '
                                 'mesh_devices, not both')
            self.mesh = [resolve_device(d) for d in mesh]
        else:
            self.mesh = make_mesh(n_mesh, self.device) if n_mesh > 1 else None
        self.run_dir = run_dir
        self.log = log if log is not None else sys.stderr
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)

        # The host spans of this engine's runs (written per sample beside
        # timings.tsv); the reference's tables are the run's first span.
        self.spans = spans.Recorder()
        with self.spans.active(), spans.span('run:reference', memory=True):
            self.ref_store = ref if isinstance(ref, SeqStore) else SeqStore.from_file(ref)
            self.ref_info = vcf_mod.ref_info_table(self.ref_store)
            self.n_gaps = self.ref_store.n_gap_table()
            self.n_index = (build_interval_index_by_chrom(self.n_gaps)
                            if self.n_gaps.shape[0] else {})
        self._aligner = None
        self.timings = {}  # {(label, stage): seconds}, from the stage spans

    # ---------------------------------------------------------------- stages

    @property
    def aligner(self):
        if self._aligner is None:
            self._aligner = Aligner(self.ref_store, self.config, device=self.device,
                                    ladder=self.ladder)
            if self.mesh is not None:
                self._aligner.dp = BandedAligner(
                    self._aligner.dp.scoring, device=self.device, mesh=self.mesh)
        return self._aligner

    def _logmsg(self, msg):
        self.log.write(f'[pav_tpu_torch] {msg}\n')
        self.log.flush()

    @contextlib.contextmanager
    def _timed(self, label, stage):
        """Time a stage as span ``label:stage`` into ``timings``, with the
        process's memory counts (``spans.memory_kib``)."""
        with spans.span(f'{label}:{stage}', label=label, memory=True) as sp:
            yield sp
        self.timings[(label, stage)] = round(sp.seconds, 3)

    def run_haplotype(self, qry_store, hap, config=None, label=None,
                      qry_filter_df=None):
        """Run alignment through integration for one haplotype.

        :param qry_filter_df: Optional query-space filter regions
            (['#CHROM','POS','END'], #CHROM = contig names); intersecting
            variants get FILTER=QRY_FILTER (reference: pavlib/call.py:521-539).
        """
        cfg = config or self.config
        res = HaplotypeResult()
        label = label or hap

        self._logmsg(f'{hap}: aligning {len(qry_store.names())} contigs '
                     f'({qry_store.total_bp() / 1e6:.2f} Mbp)')
        with self._timed(label, 'align'):
            df_align = self.aligner.align_store(qry_store, hap)
        res.align_none = finalize_align_table(
            df_align, batch_count=int(cfg.get('cigar_batch_count', 10)))

        qry_fai = qry_store.fai()
        min_trim = int(cfg.get('min_trim_tig_len', 1000))
        redundant = bool(cfg.get('redundant_callset', False))

        self._logmsg(f'{hap}: trimming {res.align_none.shape[0]} records')
        with self._timed(label, 'trim'):
            res.align_qry = trim_alignments(res.align_none, min_trim, qry_fai, mode='tig')
            res.align_qryref = trim_alignments(
                res.align_qry, min_trim, qry_fai, match_tig=redundant, mode='ref')

        with self._timed(label, 'depth'):
            res.depth_qry = depth_table(res.align_qry, self.ref_store.fai())

        # CIGAR calls on untrimmed records; TRIM filter against trimmed bounds
        # (reference: rules/call.snakefile:792-846).
        self._logmsg(f'{hap}: CIGAR variant extraction')
        with self._timed(label, 'cigar_call'):
            df_snv, df_insdel = make_insdel_snv_calls(
                res.align_none, self.ref_store, qry_store, hap, version_ids=False)

        trim_bounds = res.align_qryref.set_index('INDEX')[['POS', 'END']].astype(int)

        def trim_filter(df):
            if df.shape[0] == 0:
                df['FILTER'] = pd.Series(dtype=object)
                return df
            sub = trim_bounds.reindex(df['ALIGN_INDEX'].astype(int), fill_value=-1)
            keep = ((df['POS'].to_numpy() > sub['POS'].to_numpy())
                    & (df['END'].to_numpy() < sub['END'].to_numpy()))
            df = df.copy()
            df['FILTER'] = np.where(keep, 'PASS', 'TRIM')
            return df

        res.df_snv = trim_filter(df_snv)
        res.df_insdel = trim_filter(df_insdel)

        # Large SV scan on fully-trimmed alignments.
        self._logmsg(f'{hap}: alignment-truncating SV scan')
        log_buf = _io.StringIO()
        with self._timed(label, 'largesv'):
            res.df_lg_ins, res.df_lg_del, res.df_lg_inv = largesv.scan_for_events(
                res.align_qryref, self.ref_store, qry_store, hap,
                k_size=int(cfg.get('inv_k_size', 31)),
                n_index=self.n_index, log=log_buf,
                max_qry_dist_prop=float(cfg.get('lg_max_qry_dist_prop', 1.0)),
                max_ref_dist_prop=float(cfg.get('lg_max_ref_dist_prop', 3.0)),
                max_region_size=int(cfg.get('inv_region_limit', inv_mod.MAX_REGION_SIZE)),
                strict_parity=bool(cfg.get('strict_parity', False)),
                inv_call_out=res.inv_calls,
                version_ids=True, device=self.device)

        # Inversion flagging from CIGAR calls. strict_parity replicates two
        # reference bugs (pinned by test_inv_flag_rules_parity): the insdel
        # flag merge drops its final region, and call_inv_cluster sets
        # cluster_win_min = cluster_win (snakefile:619), not the documented
        # 500 bp default.
        strict = bool(cfg.get('strict_parity', False))
        cluster_win = int(cfg.get('inv_sig_cluster_win', 200))
        cluster_win_min = (cluster_win if strict
                           else int(cfg.get('inv_sig_cluster_win_min', 500)))
        self._logmsg(f'{hap}: inversion flagging and density scan')
        res.df_flag = inv_flag.merge_flagged_loci(
            inv_flag.flag_insdel_cluster(
                res.df_insdel, 'sv',
                flank_cluster=int(cfg.get('inv_sig_insdel_cluster_flank', 2)),
                flank_merge=int(cfg.get('inv_sig_insdel_merge_flank', 2000)),
                strict_parity=strict),
            inv_flag.flag_insdel_cluster(
                res.df_insdel, 'indel',
                flank_cluster=int(cfg.get('inv_sig_insdel_cluster_flank', 2)),
                flank_merge=int(cfg.get('inv_sig_insdel_merge_flank', 2000)),
                cluster_min_svlen=int(cfg.get('inv_sig_cluster_svlen_min', 4)),
                strict_parity=strict),
            inv_flag.flag_cluster(
                res.df_insdel, 'indel',
                cluster_win=cluster_win,
                cluster_win_min=cluster_win_min,
                cluster_min_indel=int(cfg.get('inv_sig_cluster_indel_min', 10))),
            inv_flag.flag_cluster(
                res.df_snv, 'snv',
                cluster_win=cluster_win,
                cluster_win_min=cluster_win_min,
                cluster_min_snv=int(cfg.get('inv_sig_cluster_snv_min', 20))),
            flank=int(cfg.get('inv_sig_merge_flank', 500)),
            batch_count=int(cfg.get('inv_sig_batch_count', 60)),
            inv_sig_filter=cfg.get('inv_sig_filter', 'svindel'))

        with self._timed(label, 'inv_scan'):
            res.df_inv = self._scan_flagged_inversions(res, qry_store, hap, cfg, log_buf)

        # Callable regions.
        res.callable = callable_regions(
            res.align_qryref, res.df_lg_del, res.df_lg_ins, res.df_lg_inv,
            flank=int(cfg.get('callable_flank', 500)))

        # Integrate.
        self._logmsg(f'{hap}: integrating call sources')
        with self._timed(label, 'integrate'):
            res.integrated = integrate_sources(
                res.df_insdel, res.df_snv, res.df_lg_ins, res.df_lg_del,
                res.df_lg_inv, res.df_inv, res.depth_qry, cfg,
                qry_filter_df=qry_filter_df)

        # Resolve redundant TRIM-failed calls (reference:
        # rules/call.snakefile:287-485): one representative per site in the
        # nonredundant FAIL set; PASS-intersecting fails become redundant.
        from .call.redundancy import resolve_fail_redundancy
        res.fail_redundant = {}
        for varsvtype, (df_pass, df_fail) in list(res.integrated.items()):
            svtype = varsvtype.split('_')[1]
            strategy = get_merge_params(svtype, cfg)
            nr, red = resolve_fail_redundancy(df_pass, df_fail, res.align_none, strategy)
            res.integrated[varsvtype] = (df_pass, nr)
            res.fail_redundant[varsvtype] = red
        return res

    def _scan_flagged_inversions(self, res, qry_store, hap, cfg, log_buf):
        """Scan accepted flagged regions for inversions
        (reference: rules/call_inv.snakefile:115-311)."""
        k_util = KmerUtil(int(cfg.get('inv_k_size', 31)))
        align_lift = AlignLift(res.align_qryref, qry_store.fai(),
                               strict_parity=bool(cfg.get('strict_parity', False)))
        id_set = set()
        rows = []
        flags = res.df_flag.loc[res.df_flag['TRY_INV']] if res.df_flag.shape[0] else res.df_flag
        flag_rows = [row for _, row in flags.iterrows()]

        def scan_one(row):
            """Scan one flagged region (regions are independent; device FFT
            work overlaps other regions' host work)."""
            region_flag = Region(row['#CHROM'], row['POS'], row['END'])
            try:
                return inv_mod.scan_for_inv(
                    region_flag, self.ref_store, qry_store, align_lift, k_util,
                    n_index=self.n_index,
                    max_region_size=int(cfg.get('inv_region_limit', inv_mod.MAX_REGION_SIZE)),
                    log=log_buf,
                    min_exp_count=int(cfg.get('inv_min_expand',
                                              cfg.get('inv_min_expand_count', 1)) or 1),
                    strict_parity=bool(cfg.get('strict_parity', False)),
                    device=self.device)
            except RuntimeError as ex:
                # A region's scan may fail soft (lift or flank errors); a
                # device error stops the run.
                if isinstance(ex, (torch.OutOfMemoryError, torch.AcceleratorError)):
                    raise
                log_buf.write(f'RuntimeError in scan_for_inv(): {ex}\n')
                return None

        with pools.Executor('inv_scan', min(4, len(flag_rows))) as pool:
            inv_calls = list(pool.map(scan_one, flag_rows))

        # Dedup and row assembly stay sequential in flag order so IDs and
        # artifact ordering are deterministic regardless of thread timing.
        for row, inv_call in zip(flag_rows, inv_calls):
            if inv_call is None or inv_call.id in id_set:
                continue
            seq = qry_store.fetch_region(inv_call.region_tig_outer)
            from .util import collapse_to_set
            align_index = ','.join(sorted(collapse_to_set(
                (inv_call.region_ref_outer.pos_aln_index,
                 inv_call.region_ref_outer.end_aln_index,
                 inv_call.region_ref_inner.pos_aln_index,
                 inv_call.region_ref_inner.end_aln_index),
                to_type=str) - {'None'}))
            rows.append((
                inv_call.region_ref_outer.chrom,
                inv_call.region_ref_outer.pos,
                inv_call.region_ref_outer.end,
                inv_call.id, 'INV', inv_call.svlen, hap,
                inv_call.region_tig_outer.to_base1_string(),
                '-' if inv_call.region_tig_outer.is_rev else '+',
                0,
                inv_call.region_ref_inner.to_base1_string(),
                inv_call.region_tig_inner.to_base1_string(),
                inv_call.region_ref_discovery.to_base1_string(),
                inv_call.region_tig_discovery.to_base1_string(),
                inv_call.region_flag.region_id(), row['TYPE'],
                align_index, constants.CALL_SOURCE_FLAG_DEN, 'PASS',
                seqcodec.decode(seq)))
            id_set.add(inv_call.id)
            res.inv_calls.append(inv_call)
        df = pd.DataFrame(rows, columns=largesv.INV_COLUMNS)
        if df.shape[0]:
            df = df.sort_values(['#CHROM', 'POS', 'END', 'ID']).reset_index(drop=True)
        return df

    # --------------------------------------------------------------- resume

    def _hap_artifact_dir(self, asm_name, hap):
        return os.path.join(self.run_dir, asm_name, hap) if self.run_dir else None

    def load_hap_artifacts(self, asm_name, hap):
        """Load a haplotype's persisted stage artifacts (checkpoint/resume —
        the reference's file-target semantics, SURVEY.md §5-checkpoint).

        :return: HaplotypeResult or None if any artifact is missing.
        """
        hdir = self._hap_artifact_dir(asm_name, hap)
        if hdir is None or not os.path.isdir(hdir):
            return None
        res = HaplotypeResult()
        for fname, attr in _HAP_ARTIFACTS:
            path = os.path.join(hdir, f'{fname}.tsv.gz')
            if not os.path.isfile(path):
                return None
            setattr(res, attr, pd.read_csv(
                path, sep='\t', dtype={'#CHROM': str, 'QRY_ID': str},
                keep_default_na=False, na_values=['']))
        return res

    def resume_haplotype(self, asm_name, hap, cfg, qry_filter_df=None):
        """Rebuild a HaplotypeResult from artifacts, recomputing only the cheap
        integration tail (filters/depth/redundancy are deterministic)."""
        res = self.load_hap_artifacts(asm_name, hap)
        if res is None:
            return None
        from .call.redundancy import resolve_fail_redundancy
        res.integrated = integrate_sources(
            res.df_insdel, res.df_snv, res.df_lg_ins, res.df_lg_del,
            res.df_lg_inv, res.df_inv, res.depth_qry, cfg,
            qry_filter_df=qry_filter_df)
        res.fail_redundant = {}
        for varsvtype, (df_pass, df_fail) in list(res.integrated.items()):
            svtype = varsvtype.split('_')[1]
            strategy = get_merge_params(svtype, cfg)
            nr, red = resolve_fail_redundancy(df_pass, df_fail, res.align_none, strategy)
            res.integrated[varsvtype] = (df_pass, nr)
            res.fail_redundant[varsvtype] = red
        return res

    # ------------------------------------------------------------- sample run

    def run_sample(self, asm_name, hap_inputs, config=None, write_vcf=True,
                   resume=False, qry_filters=None):
        """Run the full pipeline for one sample.

        :param hap_inputs: {hap: SeqStore or path-spec string}.
        :param qry_filters: Optional {hap: filter-region DataFrame} — variants
            intersecting these query-space regions get FILTER=QRY_FILTER
            (reference: FILTER_* assembly-table columns, pavlib/call.py:521-539).

        :return: dict with per-hap results, merged tables, and the VCF path.
        """
        with self.spans.active():
            return self._run_sample(asm_name, hap_inputs, config, write_vcf, resume,
                                    qry_filters)

    def _run_sample(self, asm_name, hap_inputs, config, write_vcf, resume, qry_filters):
        cfg = config or self.config
        qry_filters = qry_filters or {}
        hap_results = {}
        to_run = []
        with spans.span(f'{asm_name}:load', label=asm_name, memory=True):
            for hap, inp in hap_inputs.items():
                if resume:
                    loaded = self.resume_haplotype(asm_name, hap, cfg,
                                                   qry_filter_df=qry_filters.get(hap))
                    if loaded is not None:
                        self._logmsg(f'{asm_name}/{hap}: resumed from artifacts')
                        hap_results[hap] = loaded
                        continue
                store = (inp if isinstance(inp, SeqStore)
                         else load_haplotype_seqs(inp, asm_name, hap))
                if not store.names():
                    self._logmsg(f'{asm_name}/{hap}: no input sequence, skipping haplotype')
                    continue
                to_run.append((hap, store))

        # Haplotypes run concurrently: the hot kernels (native C++, device DP)
        # release the GIL, so two haplotype threads overlap host and device
        # work (the reference fans haplotypes out as independent cluster jobs:
        # SURVEY.md §2.8). The shared index is built before the threads start.
        if to_run:
            with spans.span(f'{asm_name}:index', label=asm_name, memory=True):
                self.aligner
        with spans.span(f'{asm_name}:haplotypes', label=asm_name, memory=True):
            with pools.Executor('haplotypes', min(len(to_run), 4)) as pool:
                futures = {
                    hap: pool.submit(self.run_haplotype, store, hap, cfg,
                                     f'{asm_name}/{hap}',
                                     qry_filter_df=qry_filters.get(hap))
                    for hap, store in to_run
                }
                for hap, fut in futures.items():
                    hap_results[hap] = fut.result()

        hap_list = list(hap_results.keys())

        # Per-hap artifacts depend only on finished haplotypes: write them on
        # a background thread while the diploid merge runs (gzip releases the
        # GIL). Only the merged_* tables wait for the merge.
        art_thread = None
        if self.run_dir:
            def write_hap_artifacts():
                with spans.span(f'{asm_name}:hap_artifacts', label=asm_name, memory=True):
                    self._write_hap_artifacts(asm_name, hap_results, dict(to_run))
            art_thread = pools.start_thread(write_hap_artifacts)

        with self._timed(asm_name, 'merge'):
            merged = self._merge_all(asm_name, hap_results, hap_list, cfg)

        vcf_path = None
        if write_vcf:
            out_dir = self.run_dir or '.'
            prefix = cfg.get('vcf_prefix', '') or ''
            vcf_path = os.path.join(out_dir, f'{prefix}{asm_name}.vcf.gz')
            self._logmsg(f'{asm_name}: writing VCF {vcf_path}')
            with self._timed(asm_name, 'vcf'):
                vcf_mod.write_merged_vcf(
                    asm_name,
                    {key: df for key, df in merged.items()},
                    vcf_path, self.ref_store, self.ref_info)

        if self.run_dir:
            with self._timed(asm_name, 'artifacts'):
                self._write_merged_artifacts(asm_name, merged)
                if art_thread is not None:
                    art_thread.join()
            self._write_timings(asm_name)

        return {'haps': hap_results, 'merged': merged, 'vcf': vcf_path}

    def _write_timings(self, asm_name):
        """Stage wall seconds of this sample -> <run_dir>/<sample>/timings.tsv
        (LABEL is the sample, or sample/hap for per-haplotype stages), and
        the sample's spans with the run's own -> spans.tsv beside it."""
        rows = [(label, stage, secs) for (label, stage), secs in self.timings.items()
                if label == asm_name or label.startswith(f'{asm_name}/')]
        base = os.path.join(self.run_dir, asm_name)
        pd.DataFrame(rows, columns=['LABEL', 'STAGE', 'SECONDS']).to_csv(
            os.path.join(base, 'timings.tsv'), sep='\t', index=False)
        spans.write_tsv(self.spans.sample(asm_name), os.path.join(base, 'spans.tsv'))

    def _write_inv_figures(self, hdir, res, qry_store, figures=True):
        """Persist each accepted inversion's k-mer density table and (with
        figures=True, config artifacts=full) the dotplot + density figures the
        reference generates as separate figure targets."""
        if not res.inv_calls:
            return
        if figures:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt

            from . import plot as plot_mod

        dens_dir = os.path.join(hdir, 'inv_density')
        fig_dir = os.path.join(hdir, 'figures')
        os.makedirs(dens_dir, exist_ok=True)
        if figures:
            os.makedirs(fig_dir, exist_ok=True)
        for inv_call in res.inv_calls:
            safe_id = inv_call.id.replace('/', '_')
            if inv_call.df is not None:
                inv_call.df.to_csv(
                    os.path.join(dens_dir, f'{safe_id}.tsv.gz'),
                    sep='\t', index=False, compression={'method': 'gzip', 'compresslevel': 2})
                if figures:
                    plot_mod.density_plot(
                        inv_call.df, title=inv_call.id,
                        out_path=os.path.join(fig_dir, f'{safe_id}_density.png'))
            if figures and qry_store is not None:
                ref_codes = self.ref_store.fetch_region(
                    inv_call.region_ref_discovery, rev_compl=False)
                tig_codes = qry_store.fetch_region(inv_call.region_tig_discovery)
                fig, ax = plt.subplots(figsize=(6, 6))
                plot_mod.kmer_dotplot(
                    ref_codes, tig_codes, ax=ax, title=inv_call.id,
                    inner=(inv_call.region_ref_inner.pos - inv_call.region_ref_discovery.pos,
                           inv_call.region_ref_inner.end - inv_call.region_ref_discovery.pos),
                    outer=(inv_call.region_ref_outer.pos - inv_call.region_ref_discovery.pos,
                           inv_call.region_ref_outer.end - inv_call.region_ref_discovery.pos))
                fig.savefig(os.path.join(fig_dir, f'{safe_id}_dotplot.png'), dpi=150)
                plt.close(fig)

    def _merge_all(self, asm_name, hap_results, hap_list, cfg):
        """Diploid merge of every (varsvtype, tier), sharded by length-balanced
        chromosome batches (reference: rules/call.snakefile:856-905 packs
        chromosomes into MERGE_BATCH_COUNT bins and merges each as an
        independent job). Here each callset tier is one task of the merge
        pool (span ``merge.job``); where its calls lie in more than one
        batch, it merges those batches one after another inside the task
        (a ``merge.shard`` span each), then concatenates and sorts them
        (``merge.concat``)."""
        from .call.batching import merge_batch_table

        batch_df = merge_batch_table(dict(self.ref_store.fai()))
        chrom_batches = [
            set(batch_df.index[batch_df['BATCH'] == b])
            for b in sorted(batch_df['BATCH'].unique())
        ]

        jobs = []  # (key, bed_list, callable_list, strategy)
        for varsvtype in ('svindel_ins', 'svindel_del', 'sv_inv', 'snv_snv'):
            svtype = varsvtype.split('_')[1]
            strategy = get_merge_params(svtype, cfg)
            for tier_i, tier in enumerate(('pass', 'fail')):
                bed_list = [hap_results[h].integrated[varsvtype][tier_i] for h in hap_list]
                callable_list = [hap_results[h].callable for h in hap_list]
                jobs.append(((varsvtype, tier), bed_list, callable_list, strategy))

        def run_job(key, bed_list, callable_list, strategy):
            # Only shard over batches whose chromosomes actually hold calls;
            # per-chromosome merges are independent (matching never crosses
            # chromosomes), so concat+sort reproduces the unsharded result.
            beds = [bed for bed in bed_list if bed is not None and bed.shape[0]]
            present = set()
            for bed in beds:
                present.update(bed['#CHROM'].unique())
            active = [cb & present for cb in chrom_batches if cb & present]
            spans.add(type=key[0], tier=key[1], calls=sum(bed.shape[0] for bed in beds),
                      shards=len(active))
            if len(active) <= 1:
                return merge_haplotypes(bed_list, callable_list, hap_list, strategy)
            parts = []
            for chroms in active:
                with spans.span('merge.shard', chroms='+'.join(sorted(chroms)),
                                calls=sum(int(bed['#CHROM'].isin(chroms).sum())
                                          for bed in beds)):
                    parts.append(merge_haplotypes(bed_list, callable_list, hap_list,
                                                  strategy, subset_chrom=chroms))
            with spans.span('merge.concat', shards=len(parts)):
                out = pd.concat(parts, axis=0)
                out = out.sort_values(['#CHROM', 'POS', 'END', 'ID'])
                out.index.name = 'INDEX'
            return out

        merged = {}
        self._logmsg(
            f'{asm_name}: merging {len(jobs)} callset tiers across {hap_list} '
            f'({len(chrom_batches)} chromosome batches)')
        with pools.Executor('merge', 4, task_span='merge.job') as pool:
            futures = {
                key: pool.submit(run_job, key, bed_list, callable_list, strategy)
                for key, bed_list, callable_list, strategy in jobs
            }
            for key, fut in futures.items():
                merged[key] = fut.result()
        return merged

    def _write_merged_artifacts(self, asm_name, merged):
        base = os.path.join(self.run_dir, asm_name)
        os.makedirs(base, exist_ok=True)
        for (varsvtype, tier), df in merged.items():
            df.to_csv(os.path.join(base, f'merged_{varsvtype}_{tier}.tsv.gz'),
                      sep='\t', index=False, compression={'method': 'gzip', 'compresslevel': 2})

    def _write_hap_artifacts(self, asm_name, hap_results, stores=None):
        """Persist per-haplotype run outputs.

        The `artifacts` config selects the level: 'calls' (default) writes
        the stage call/alignment tables (everything resume and inspection
        need) plus per-inversion density tables; 'full' additionally emits
        the side outputs the reference builds as separate optional targets —
        dot/density figures (rules/figures.snakefile:97-269), BAM/CRAM
        (rules/align.snakefile:305-327), and browser tracks
        (rules/tracks.snakefile:99-307).
        """
        full = str(self.config.get('artifacts', 'calls')) == 'full'
        base = os.path.join(self.run_dir, asm_name)
        os.makedirs(base, exist_ok=True)
        for hap, res in hap_results.items():
            hdir = os.path.join(base, hap)
            os.makedirs(hdir, exist_ok=True)
            for name, df in (
                    ('align_trim-none', res.align_none),
                    ('align_trim-qry', res.align_qry),
                    ('align_trim-qryref', res.align_qryref),
                    ('depth_qry', res.depth_qry),
                    ('snv_snv', res.df_snv), ('svindel_insdel', res.df_insdel),
                    ('lg_ins', res.df_lg_ins), ('lg_del', res.df_lg_del),
                    ('lg_inv', res.df_lg_inv), ('inv_flag', res.df_flag),
                    ('sv_inv', res.df_inv), ('callable', res.callable)):
                if df is not None:
                    df.to_csv(os.path.join(hdir, f'{name}.tsv.gz'), sep='\t',
                              index=False, compression={'method': 'gzip', 'compresslevel': 2})
            if res.fail_redundant:
                for varsvtype, df in res.fail_redundant.items():
                    df.to_csv(os.path.join(hdir, f'fail_redundant_{varsvtype}.tsv.gz'),
                              sep='\t', index=False, compression={'method': 'gzip', 'compresslevel': 2})
            # Per-inversion density tables + dot/density figures (reference:
            # rules/call_inv.snakefile:279-282, rules/figures.snakefile:97-269).
            try:
                self._write_inv_figures(hdir, res,
                                        stores.get(hap) if stores else None,
                                        figures=full)
            except Exception as ex:  # side outputs, never fatal
                self._logmsg(f'{hap}: inversion figure emission failed: {ex}')
            if not full:
                continue
            # Reconstructed alignments as indexed BAM + CRAM (the reference
            # emits CRAM as a troubleshooting output via samtools:
            # rules/align.snakefile:305-327; both containers are written
            # natively here).
            try:
                from .io.cram import write_cram
                from .io.sam import write_bam
                store = (stores or {}).get(hap)
                if store is not None:
                    write_bam(res.align_qryref, store, self.ref_store.fai(),
                              os.path.join(hdir, 'align_trim-qryref.bam'))
                    write_cram(res.align_qryref, store, self.ref_store,
                               os.path.join(hdir, 'align_trim-qryref.cram'))
            except Exception as ex:  # side output, never fatal
                self._logmsg(f'{hap}: BAM/CRAM emission failed: {ex}')
            # Browser tracks (reference: rules/tracks.snakefile:99-307):
            # .bed.gz plus native BigBed containers (the reference's
            # bedToBigBed outputs at rules/tracks.snakefile:115,192).
            try:
                from . import tracks
                chrom_sizes = dict(self.ref_store.fai())
                tracks.alignment_track(
                    res.align_qryref, os.path.join(hdir, 'align_track.bed.gz'),
                    name=f'pav_align_{hap}')
                tracks.alignment_track_bigbed(
                    res.align_qryref, chrom_sizes,
                    os.path.join(hdir, 'align_track.bb'))
                for varsvtype, (df_pass, _) in res.integrated.items():
                    if df_pass.shape[0]:
                        tracks.variant_track(
                            df_pass, os.path.join(hdir, f'track_{varsvtype}.bed.gz'),
                            name=f'pav_{varsvtype}_{hap}')
                        tracks.variant_track_bigbed(
                            df_pass, chrom_sizes,
                            os.path.join(hdir, f'track_{varsvtype}.bb'))
            except Exception as ex:  # tracks are side outputs, never fatal
                self._logmsg(f'{hap}: track emission failed: {ex}')


def run(ref_path, asm_table_path, config=None, run_dir='pav_run', samples=None,
        resume=False, profile_dir=None, device=None):
    """CLI-style entry: run all (or selected) samples of an assembly table.

    :param profile_dir: When set, wraps the run in a torch.profiler trace of
        the host and (on CUDA) the device, written to
        ``profile_dir/trace.json`` (Chrome trace format). The profiler
        records every thread: each stage of each haplotype is a
        ``sample/hap:stage`` span on its haplotype's thread, and the pools
        keep their threads.
    :param device: torch device; None takes the config key ``device``
        (default ``cuda``).
    """
    cfg = load_config(config)
    asm_table = read_assembly_table(asm_table_path)
    pipeline = Pipeline(ref_path, cfg, run_dir=run_dir, device=device)
    results = {}

    trace_cm = contextlib.nullcontext()
    if profile_dir:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if pipeline.device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        trace_cm = profile(activities=activities,
                           experimental_config=_ExperimentalConfig(profile_all_threads=True))

    with trace_cm as prof:
        for asm_name in (samples or asm_table.index):
            local_cfg = override_config(cfg, get_asm_config_override(asm_table, asm_name))
            haps = get_hap_list(asm_table, asm_name)
            hap_inputs = {h: asm_table.loc[asm_name, f'HAP_{h}'] for h in haps}
            qry_filters = {}
            for h in haps:
                spec = get_filter_spec(asm_table, asm_name, h)
                if spec:
                    qry_filters[h] = load_filter_regions(spec, asm_name, h)
            results[asm_name] = pipeline.run_sample(
                asm_name, hap_inputs, config=local_cfg, resume=resume,
                qry_filters=qry_filters)
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, 'trace.json'))
    return results
