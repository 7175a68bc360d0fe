"""Native BigBed (bbi) writer — no external bedToBigBed dependency.

The reference converts BED9+ track files to BigBed with UCSC's bedToBigBed
binary (reference: rules/tracks.snakefile:115,192; fetched by
files/docker/build_deps.sh:103-105). This module writes the bbi container
directly: header, autoSql, total summary, chromosome B+ tree, zlib-compressed
data blocks, and the R-tree index, per the public bbi spec (Kent et al.,
"BigWig and BigBed", Bioinformatics 2010, supplementary tables 5-12).

Zoom levels are written when the item count warrants them (binned max-cover
summaries), matching bedToBigBed's behavior of omitting zooms for small
files.
"""

import struct
import zlib

import numpy as np

BIGBED_MAGIC = 0x8789F2EB
CHROM_TREE_MAGIC = 0x78CA4B1F   # bptSig (Kent bbiFile.h)
RTREE_MAGIC = 0x2468ACE0

_BLOCK_SIZE = 256        # B+/R tree fan-out
_ITEMS_PER_SLOT = 512    # BED items per data block
_ZOOM_ITEMS_PER_SLOT = 32


DEFAULT_AUTOSQL = """table bed9plus
"BED9+ track"
(
string chrom;      "Chromosome"
uint   chromStart; "Start"
uint   chromEnd;   "End"
string name;       "Item name"
uint   score;      "Score 0-1000"
char[1] strand;    "+ or -"
uint   thickStart; "Thick start"
uint   thickEnd;   "Thick end"
uint   reserved;   "itemRgb"
)
"""


def _pack_header(field_count, defined_field_count, autosql_off, total_summary_off,
                 chrom_tree_off, full_data_off, full_index_off,
                 uncompress_buf_size, zoom_levels, zoom_headers):
    hdr = struct.pack(
        '<IHHQQQHHQQIQ',
        BIGBED_MAGIC, 4, zoom_levels,
        chrom_tree_off, full_data_off, full_index_off,
        field_count, defined_field_count,
        autosql_off, total_summary_off,
        uncompress_buf_size, 0)
    assert len(hdr) == 64
    for red_level, data_off, index_off in zoom_headers:
        hdr += struct.pack('<IIQQ', red_level, 0, data_off, index_off)
    return hdr


def _chrom_bptree(chrom_ids, chrom_sizes):
    """One-level (or two-level) chromosome B+ tree. Keys are fixed-width,
    NUL-padded chromosome names; values are (id, size)."""
    names = list(chrom_ids.keys())
    key_size = max(len(n) for n in names) if names else 1
    items = sorted((n.encode()[:key_size].ljust(key_size, b'\0'),
                    chrom_ids[n], chrom_sizes[n]) for n in names)
    out = struct.pack('<IIIIQQ', CHROM_TREE_MAGIC, _BLOCK_SIZE, key_size, 8,
                      len(items), 0)
    # All leaves fit one node for any realistic assembly at fan-out 256;
    # chunk into multiple leaf nodes under a root otherwise.
    if len(items) <= _BLOCK_SIZE:
        out += struct.pack('<BBH', 1, 0, len(items))
        for key, cid, size in items:
            out += key + struct.pack('<II', cid, size)
        return out
    # Two-level tree.
    leaves = [items[i:i + _BLOCK_SIZE] for i in range(0, len(items), _BLOCK_SIZE)]
    root = struct.pack('<BBH', 0, 0, len(leaves))
    # Root node layout: key + 8-byte child offset per leaf.
    header_len = len(out) + 4 + len(leaves) * (key_size + 8)
    offsets = []
    body = b''
    for leaf in leaves:
        offsets.append(header_len + len(body))
        node = struct.pack('<BBH', 1, 0, len(leaf))
        for key, cid, size in leaf:
            node += key + struct.pack('<II', cid, size)
        body += node
    for leaf, off in zip(leaves, offsets):
        root += leaf[0][0] + struct.pack('<Q', off)
    return out + root + body


class _RLeaf:
    __slots__ = ('start_cix', 'start', 'end_cix', 'end', 'offset', 'size')

    def __init__(self, start_cix, start, end_cix, end, offset, size):
        self.start_cix = start_cix
        self.start = start
        self.end_cix = end_cix
        self.end = end
        self.offset = offset
        self.size = size


def _rtree(leaves, tree_offset, items_per_slot=_ITEMS_PER_SLOT,
           end_file_offset=None):
    """Serialize an R-tree over data blocks (bbi spec tables 14-16).

    :param tree_offset: absolute file offset where this tree is written
        (child pointers in non-leaf nodes are absolute file offsets).
    :param end_file_offset: end of the indexed data section; defaults to
        tree_offset (data ends where the index begins).
    """
    if end_file_offset is None:
        end_file_offset = tree_offset
    n = len(leaves)
    if n:
        s_cix = min(l.start_cix for l in leaves)
        s_base = min(l.start for l in leaves if l.start_cix == s_cix)
        e_cix = max(l.end_cix for l in leaves)
        e_base = max(l.end for l in leaves if l.end_cix == e_cix)
    else:
        s_cix = s_base = e_cix = e_base = 0
    out = struct.pack('<IIQIIIIQII', RTREE_MAGIC, _BLOCK_SIZE, n,
                      s_cix, s_base, e_cix, e_base,
                      end_file_offset, items_per_slot, 0)
    header_size = len(out)

    # Non-leaf nodes reference children by absolute file offset, so serialize
    # top-down with explicit offsets. Leaf item = 32 bytes, child item = 24.
    def node_groups(items):
        return [items[i:i + _BLOCK_SIZE] for i in range(0, len(items), _BLOCK_SIZE)]

    def child_node_bytes(n_children):
        return 4 + 24 * n_children

    def bounds(group):
        # group is a list of _RLeaf or nested groups
        flat = []

        def collect(g):
            for x in g:
                if isinstance(x, _RLeaf):
                    flat.append(x)
                else:
                    collect(x)
        collect(group)
        s_cix = min(x.start_cix for x in flat)
        s = min(x.start for x in flat if x.start_cix == s_cix)
        e_cix = max(x.end_cix for x in flat)
        e = max(x.end for x in flat if x.end_cix == e_cix)
        return s_cix, s, e_cix, e

    def write_node(group, at):
        """Serialize node for `group` at offset `at`; returns bytes."""
        is_leaf = group and isinstance(group[0], _RLeaf)
        if is_leaf:
            node = struct.pack('<BBH', 1, 0, len(group))
            for l in group:
                node += struct.pack('<IIIIQQ', l.start_cix, l.start,
                                    l.end_cix, l.end, l.offset, l.size)
            return node
        node = struct.pack('<BBH', 0, 0, len(group))
        child_at = at + child_node_bytes(len(group))
        child_blobs = []
        for child in group:
            sb = bounds(child)
            node += struct.pack('<IIIIQ', sb[0], sb[1], sb[2], sb[3], child_at)
            blob = write_node(child, child_at)
            child_blobs.append(blob)
            child_at += len(blob)
        return node + b''.join(child_blobs)

    # (write_node appends children depth-first immediately after the parent
    # node, so a parent's children occupy a contiguous span at child_at.)

    if n == 0:
        root_group = []
    elif len(leaves) <= _BLOCK_SIZE:
        root_group = leaves
    else:
        # Nest groups until the top level fits one node.
        grouped = leaves
        while len(grouped) > _BLOCK_SIZE:
            grouped = node_groups(grouped)
        root_group = grouped

    body = write_node(root_group, tree_offset + header_size)
    return out + body


def _encode_items(df, chrom_ids, extra_cols):
    """DataFrame rows -> sorted list of (chromId, start, end, rest_bytes)."""
    chrom_col = df['#CHROM'].astype(str).tolist()
    pos_col = df['POS'].astype(int).tolist()
    end_col = df['END'].astype(int).tolist()
    rest_cols = [df[c].tolist() if c in df.columns else [''] * len(df)
                 for c in extra_cols]
    items = []
    for i in range(len(df)):
        cid = chrom_ids[chrom_col[i]]
        start = pos_col[i]
        end = max(end_col[i], start + 1)
        rest = '\t'.join(str(col[i]) for col in rest_cols)
        items.append((cid, start, end, rest.encode() + b'\0'))
    items.sort(key=lambda t: (t[0], t[1], t[2]))
    return items


def write_bigbed(df, chrom_sizes, out_path, extra_cols=(),
                 autosql=DEFAULT_AUTOSQL, compress=True):
    """Write a BED-like DataFrame (#CHROM, POS, END + extra_cols) as BigBed.

    :param df: table with #CHROM/POS/END plus the columns in extra_cols
        (these become BED fields 4+ in order).
    :param chrom_sizes: {chrom: length} for every chromosome referenced.
    :param out_path: output .bb path.
    :param extra_cols: ordered column names appended after chromEnd.
    :param autosql: autoSql schema string describing 3 + len(extra_cols) fields.
    """
    chrom_names = sorted(chrom_sizes)
    chrom_ids = {n: i for i, n in enumerate(chrom_names)}

    used = set(str(c) for c in df['#CHROM'].unique()) if len(df) else set()
    missing = used - set(chrom_ids)
    if missing:
        raise ValueError(f'chromosomes missing from chrom_sizes: {sorted(missing)}')

    items = _encode_items(df, chrom_ids, list(extra_cols))
    field_count = 3 + len(extra_cols)

    # --- data blocks
    blocks = []  # (_RLeaf bounds filled later after offsets known)
    raw_blocks = []
    for i in range(0, len(items), _ITEMS_PER_SLOT):
        chunk = items[i:i + _ITEMS_PER_SLOT]
        raw = b''.join(struct.pack('<III', cid, s, e) + rest
                       for cid, s, e, rest in chunk)
        raw_blocks.append((chunk, raw))

    uncompress_buf = max((len(r) for _, r in raw_blocks), default=0)

    # --- summary stats (coverage-based, matching bedToBigBed semantics:
    # validCount = covered bases, min/max = per-base depth extremes)
    cov = {}
    for cid, s, e, _ in items:
        cov.setdefault(cid, []).append((s, e))
    valid = 0
    max_depth = 0.0
    sum_data = 0.0
    sum_sq = 0.0
    min_depth = 0.0
    for cid, spans in cov.items():
        ev = []
        for s, e in spans:
            ev.append((s, 1))
            ev.append((e, -1))
        ev.sort()
        depth = 0
        prev = None
        for pos, d in ev:
            if prev is not None and depth > 0 and pos > prev:
                ln = pos - prev
                valid += ln
                sum_data += depth * ln
                sum_sq += depth * depth * ln
                max_depth = max(max_depth, depth)
                min_depth = depth if min_depth == 0 else min(min_depth, depth)
            depth += d
            prev = pos

    # --- zoom levels (coverage summaries at growing reductions)
    zoom_levels = []
    if len(items) > 2 * _ITEMS_PER_SLOT:
        span = max(e for _, _, e, _ in items) - min(s for _, s, _, _ in items)
        red = max(span // 1000, 16)
        while len(zoom_levels) < 6:
            zoom_levels.append(red)
            red *= 4
            if red > 2 ** 30:
                break

    def zoom_rows(reduction):
        rows = []
        for cid in sorted(cov):
            binned = {}
            for s, e in cov[cid]:
                for b in range(s // reduction, (e - 1) // reduction + 1):
                    bs, be = b * reduction, (b + 1) * reduction
                    os_, oe = max(s, bs), min(e, be)
                    if oe <= os_:
                        continue
                    st = binned.setdefault(b, [oe - os_, 0])
                    st[0] = max(st[0], oe - os_)
                    st[1] += oe - os_
            for b, (mx, total) in sorted(binned.items()):
                bs, be = b * reduction, min((b + 1) * reduction,
                                            chrom_sizes[chrom_names[cid]])
                val = total / max(be - bs, 1)
                rows.append(struct.pack('<IIIIffff', cid, bs, be, total,
                                        val, val, val, val))
        return rows

    with open(out_path, 'wb') as fh:
        # Reserve header + zoom headers; rewrite at the end.
        n_zoom = len(zoom_levels)
        fh.write(b'\0' * (64 + 24 * n_zoom))

        autosql_off = fh.tell()
        fh.write(autosql.encode() + b'\0')

        total_summary_off = fh.tell()
        fh.write(struct.pack('<Qdddd', valid, min_depth, max_depth,
                             sum_data, sum_sq))

        chrom_tree_off = fh.tell()
        fh.write(_chrom_bptree(chrom_ids, chrom_sizes))

        full_data_off = fh.tell()
        fh.write(struct.pack('<Q', len(items)))
        leaves = []
        for chunk, raw in raw_blocks:
            payload = zlib.compress(raw) if compress else raw
            off = fh.tell()
            fh.write(payload)
            # End bound is the maximal (chromIx, end) KEY: the max end among
            # items on the block's last chromosome — not the max end across
            # all chromosomes in the block (caught by test_golden_bytes).
            e_cix = max(c for c, _, _, _ in chunk)
            e_base = max(e for c, _, e, _ in chunk if c == e_cix)
            leaves.append(_RLeaf(chunk[0][0], chunk[0][1],
                                 e_cix, e_base, off, len(payload)))
        full_index_off = fh.tell()
        fh.write(_rtree(leaves, full_index_off))

        zoom_headers = []
        for red in zoom_levels:
            rows = zoom_rows(red)
            zdata_off = fh.tell()
            fh.write(struct.pack('<I', len(rows)))
            zleaves = []
            for i in range(0, len(rows), _ZOOM_ITEMS_PER_SLOT):
                chunk = rows[i:i + _ZOOM_ITEMS_PER_SLOT]
                raw = b''.join(chunk)
                payload = zlib.compress(raw) if compress else raw
                off = fh.tell()
                first = struct.unpack_from('<III', chunk[0])
                last = struct.unpack_from('<III', chunk[-1])
                fh.write(payload)
                zleaves.append(_RLeaf(first[0], first[1], last[0], last[2],
                                      off, len(payload)))
                uncompress_buf = max(uncompress_buf, len(raw))
            zindex_off = fh.tell()
            fh.write(_rtree(zleaves, zindex_off,
                            items_per_slot=_ZOOM_ITEMS_PER_SLOT))
            zoom_headers.append((red, zdata_off, zindex_off))

        fh.write(struct.pack('<I', BIGBED_MAGIC))  # trailer magic (spec)

        fh.seek(0)
        fh.write(_pack_header(
            field_count, field_count, autosql_off, total_summary_off,
            chrom_tree_off, full_data_off, full_index_off,
            uncompress_buf if compress else 0, n_zoom, zoom_headers))


# ---------------------------------------------------------------- reader

def read_bigbed(path):
    """Minimal independent BigBed reader (validation/tests): returns
    (header dict, {chrom: size}, [(chrom, start, end, rest_str), ...])."""
    with open(path, 'rb') as fh:
        data = fh.read()
    (magic, version, zoom_levels, chrom_tree_off, full_data_off,
     full_index_off, field_count, defined_field_count, autosql_off,
     total_summary_off, uncompress_buf, _res) = struct.unpack_from(
        '<IHHQQQHHQQIQ', data, 0)
    if magic != BIGBED_MAGIC:
        raise ValueError('not a BigBed file')
    hdr = {'version': version, 'zoomLevels': zoom_levels,
           'fieldCount': field_count, 'definedFieldCount': defined_field_count}

    # Chromosome tree.
    (cmagic, block_size, key_size, val_size, item_count, _r) = struct.unpack_from(
        '<IIIIQQ', data, chrom_tree_off)
    if cmagic != CHROM_TREE_MAGIC:
        raise ValueError('bad chrom tree magic')
    chroms = {}
    id_to_name = {}

    def walk_chrom(off):
        is_leaf, _, count = struct.unpack_from('<BBH', data, off)
        p = off + 4
        if is_leaf:
            for _ in range(count):
                key = data[p:p + key_size].rstrip(b'\0').decode()
                cid, size = struct.unpack_from('<II', data, p + key_size)
                chroms[key] = size
                id_to_name[cid] = key
                p += key_size + 8
        else:
            for _ in range(count):
                child, = struct.unpack_from('<Q', data, p + key_size)
                walk_chrom(child)
                p += key_size + 8

    walk_chrom(chrom_tree_off + 32)

    n_items, = struct.unpack_from('<Q', data, full_data_off)

    # Walk the R-tree collecting leaf blocks.
    (rmagic,) = struct.unpack_from('<I', data, full_index_off)
    if rmagic != RTREE_MAGIC:
        raise ValueError('bad rtree magic')
    blocks = []

    def walk_r(off):
        is_leaf, _, count = struct.unpack_from('<BBH', data, off)
        p = off + 4
        if is_leaf:
            for _ in range(count):
                _scix, _s, _ecix, _e, boff, bsize = struct.unpack_from(
                    '<IIIIQQ', data, p)
                blocks.append((boff, bsize))
                p += 32
        else:
            for _ in range(count):
                vals = struct.unpack_from('<IIIIQ', data, p)
                walk_r(vals[4])
                p += 24

    walk_r(full_index_off + 48)

    records = []
    for boff, bsize in blocks:
        raw = data[boff:boff + bsize]
        if uncompress_buf:
            raw = zlib.decompress(raw)
        p = 0
        while p < len(raw):
            cid, s, e = struct.unpack_from('<III', raw, p)
            p += 12
            z = raw.index(b'\0', p)
            rest = raw[p:z].decode()
            p = z + 1
            records.append((id_to_name[cid], s, e, rest))
    if len(records) != n_items:
        raise ValueError(f'item count mismatch: {len(records)} != {n_items}')
    return hdr, chroms, records
