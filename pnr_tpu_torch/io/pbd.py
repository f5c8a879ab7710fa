"""Vaa3D PBD ("packed bit difference") codec for .v3dpbd volumes.

The reference loads any Vaa3D image format through
`simple_loadimage_wrapper` (pnr-vaa3d/Advantra_plugin.cpp:2241), which
includes the PBD-compressed raw format many BigNeuron gold166 stacks
ship in. This module implements the 8-bit PBD codec used by Vaa3D's
ImageLoaderBasic (decompressPBD8), plus a compressor so volumes can be
written back and the codec round-trip tested without external fixtures.

Stream grammar (one byte of code, then its operands):

* code 0..32   — literal: copy the next ``code + 1`` bytes verbatim;
* code 33..127 — difference: ``code - 32`` values follow as 2-bit
  deltas packed 4 per byte, least-significant pair first; each delta d
  maps to {0: +0, 1: +1, 2: +2, 3: -1} and accumulates onto the
  previously decoded value;
* code 128..255 — repeat: the next byte repeats ``code - 127`` times.

16-bit PBD (pbd16, 3-bit deltas) is not implemented; 16-bit inputs to
the pipeline are min-max scaled to uint8 at load time anyway, so
v3dpbd files with datatype 2 are rejected with a clear error.
"""

from __future__ import annotations

import numpy as np

_DELTA = np.array([0, 1, 2, -1], np.int16)


def decompress_pbd8(src: np.ndarray, out_size: int) -> np.ndarray:
    """Decode an 8-bit PBD stream into ``out_size`` bytes.

    Two passes: a light op walk (one Python iteration per *op*, copying
    literal/repeat spans as numpy slices and recording difference-run
    metadata), then one vectorized pass decoding ALL difference runs at
    once — 2-bit fields unpack as a (bytes, 4) shift table, each run's
    values are prior + within-run cumsum, and run priors chain through
    consecutive-run groups via per-run delta totals (grouped cumsums),
    so Python executes per OP, not per voxel (~50 bytes/iteration on
    difference-heavy streams — the common case for microscopy stacks —
    instead of one interpreter pass per decoded value).
    """
    src = np.asarray(src, np.uint8)
    out = np.empty(out_size, np.uint8)
    sb = src.tobytes()  # fast scalar indexing
    n = len(sb)
    cp = 0
    dp = 0
    prior = 0  # last explicitly-coded byte: the anchor for diff chains
    # difference-run metadata: operand offset, packed bytes, output
    # offset, value count, chain id (consecutive diff ops share a chain
    # whose values accumulate from one anchor)
    d_cp: list = []
    d_nb: list = []
    d_dp: list = []
    d_cnt: list = []
    d_chain: list = []
    anchors: list = []
    chain_open = False
    while cp < n and dp < out_size:
        code = sb[cp]
        if code < 33:  # literal
            count = code + 1
            out[dp : dp + count] = src[cp + 1 : cp + 1 + count]
            cp += count + 1
            dp += count
            prior = sb[cp - 1]
            chain_open = False
        elif code < 128:  # packed 2-bit differences
            cnt = code - 32
            nb = (cnt + 3) // 4
            if not chain_open:
                chain_open = True
                anchors.append(prior)
            d_cp.append(cp + 1)
            d_nb.append(nb)
            d_dp.append(dp)
            d_cnt.append(cnt)
            d_chain.append(len(anchors) - 1)
            cp += 1 + nb
            dp += cnt
        else:  # repeat
            count = code - 127
            value = sb[cp + 1]
            out[dp : dp + count] = value
            dp += count
            cp += 2
            prior = value
            chain_open = False
    if dp != out_size:
        raise ValueError(f"PBD stream decoded {dp} bytes, expected {out_size}")
    if d_cp:
        cp0 = np.asarray(d_cp, np.int64)
        nb = np.asarray(d_nb, np.int64)
        dp0 = np.asarray(d_dp, np.int64)
        cnt = np.asarray(d_cnt, np.int64)
        chain = np.asarray(d_chain, np.int64)
        anc = np.asarray(anchors, np.int64)
        # gather every run's packed bytes into one flat array
        nb_end = np.cumsum(nb)
        bidx = np.repeat(cp0 - (nb_end - nb), nb) + np.arange(nb_end[-1])
        quads = (src[bidx][:, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3
        # select each run's first cnt values out of its 4*nb fields
        cnt_end = np.cumsum(cnt)
        intra = np.arange(cnt_end[-1]) - np.repeat(cnt_end - cnt, cnt)
        deltas = _DELTA[
            quads.reshape(-1)[np.repeat((nb_end - nb) * 4, cnt) + intra]
        ].astype(np.int64)
        cs = np.cumsum(deltas)
        run_first = cnt_end - cnt
        run_base = cs[run_first] - deltas[run_first]  # cumsum before run
        # per-run delta totals -> chained priors within each chain
        rs_cum0 = np.concatenate([[0], np.cumsum(cs[cnt_end - 1] - run_base)])
        _, chain_first = np.unique(chain, return_index=True)
        prior_run = anc[chain] + rs_cum0[: len(cnt)] - rs_cum0[chain_first[chain]]
        vals = (np.repeat(prior_run - run_base, cnt) + cs) & 0xFF
        out[np.repeat(dp0, cnt) + intra] = vals.astype(np.uint8)
    return out


def compress_pbd8(data: np.ndarray) -> np.ndarray:
    """Encode bytes as an 8-bit PBD stream (greedy repeat/diff/literal).

    The output decodes with `decompress_pbd8` (and Vaa3D's decoder —
    any valid mix of the three ops is a legal stream); it is not
    guaranteed to be byte-identical to Vaa3D's own encoder output.
    """
    data = np.ascontiguousarray(data, np.uint8).ravel()
    n = len(data)
    out = bytearray()
    i = 0
    while i < n:
        # repeat run?
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out.append(127 + run)
            out.append(int(data[i]))
            i += run
            continue
        # difference run: deltas of consecutive bytes in {0, 1, 2, -1},
        # starting from the previously *encoded* byte (the stream prior)
        if i > 0:
            j = i
            deltas = []
            prev = int(data[i - 1])
            while j < n and len(deltas) < 95:
                d = (int(data[j]) - prev) & 0xFF
                if d in (0, 1, 2, 255):
                    deltas.append(3 if d == 255 else d)
                    prev = int(data[j])
                    j += 1
                    # stop a diff run before a long repeat run
                    if deltas[-1] == 0 and j + 2 < n and data[j] == data[j - 1] == data[j + 1]:
                        break
                else:
                    break
            if len(deltas) >= 3:
                out.append(32 + len(deltas))
                for k in range(0, len(deltas), 4):
                    byte = 0
                    for b, d in enumerate(deltas[k : k + 4]):
                        byte |= d << (2 * b)
                    out.append(byte)
                i = j
                continue
        # literal: until the next viable repeat/diff run or 33 bytes
        lit_start = i
        i += 1
        while i < n and i - lit_start < 33:
            if i + 2 < n and data[i] == data[i + 1] == data[i + 2]:
                break
            d = (int(data[i]) - int(data[i - 1])) & 0xFF
            if d in (0, 1, 2, 255) and i + 2 < n:
                d2 = (int(data[i + 1]) - int(data[i])) & 0xFF
                d3 = (int(data[i + 2]) - int(data[i + 1])) & 0xFF
                if d2 in (0, 1, 2, 255) and d3 in (0, 1, 2, 255):
                    break
            i += 1
        count = i - lit_start
        out.append(count - 1)
        out.extend(data[lit_start:i].tobytes())
    return np.frombuffer(bytes(out), np.uint8)
