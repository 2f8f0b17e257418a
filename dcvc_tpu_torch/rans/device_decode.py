"""Host-side helpers of the device rANS decode (counterpart of the host
half of dcvc_tpu/rans/device_decode.py).

The stream is split into its lanes on the host, exactly as the host
decoder does (rans.cc dcvc_rans_decoder_set_stream: pair-merged lanes,
odd lanes byte-reversed), and copied to the card once; from then on the
decoder state lives in device tensors and K2 (kernels/rans_decode.py)
threads it through every decode call of a frame or chunk.

`split_streams` is a verbatim copy (pinned by tests/test_torch_core.py):
the original's module imports jax, which the port never does.
"""

import numpy as np
import torch

from ..utils.profiling import spanned


def split_streams(stream, n_lanes, pad_to=None):
    """Split the merged wire stream into per-lane byte arrays (reversed
    for odd lanes), mirroring dcvc_rans_decoder_set_stream.

    Returns (lanes (n_lanes, L) uint8, lengths (n_lanes,) int32); L is
    max lane length (optionally rounded up to `pad_to`)."""
    buf = np.frombuffer(bytes(stream), np.uint8)
    size = buf.size
    if n_lanes == 1:
        parts = [buf]
    elif n_lanes == 2:
        parts = [buf, buf[::-1]]
    else:
        num_pairs = n_lanes // 2
        has_tail = (n_lanes % 2) != 0
        num_offsets = num_pairs - 1 + (1 if has_tail else 0)
        header = num_offsets * 4
        offsets = buf[:header].view(np.int32)
        payload = buf[header:]
        payload_size = size - header
        parts = []
        for p in range(num_pairs):
            start = 0 if p == 0 else int(offsets[p - 1])
            if p < num_offsets:
                end = int(offsets[p])
            else:
                end = int(offsets[num_offsets - 1]) if has_tail else payload_size
            seg = payload[start:end]
            parts.append(seg)
            parts.append(seg[::-1])
        if has_tail:
            parts.append(payload[int(offsets[num_offsets - 1]):])
    lengths = np.array([p.size for p in parts], np.int32)
    L = max(int(lengths.max()), 8)
    if pad_to:
        L = -(-L // pad_to) * pad_to
    lanes = np.zeros((n_lanes, L), np.uint8)
    for i, p in enumerate(parts):
        lanes[i, :p.size] = p
    return lanes, lengths


def init_state(lanes):
    """lanes (n, L) uint8 tensor -> the decoder state: streams (the lanes),
    st (n,) int32 holding each lane's uint32 rANS state, seeded from its
    first 4 bytes (little-endian), and ptr (n,) int32, the next byte (4).
    Runs on the lanes' device; nothing crosses to or from the host."""
    b = lanes[:, :4].to(torch.int64)
    st = (b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)).to(
        torch.int32)                   # the uint32's bits, wrapped
    ptr = torch.full((lanes.shape[0],), 4, dtype=torch.int32,
                     device=lanes.device)
    return {"streams": lanes, "st": st, "ptr": ptr}


@spanned("entropy.upload")
def upload_lanes(stream, n_lanes, device):
    """The host half of a device decode: split `stream` into its n_lanes
    lanes and copy them to `device` (the only host-to-device copy of the
    decode).  Each lane is zero-padded to a multiple of 16 bytes, the
    chunk K2 reads its bytes in.  To a CUDA device the copy goes through
    pinned memory and does not block the host."""
    from ..runtime.host_copy import to_device   # (runtime imports this)
    lanes, _ = split_streams(stream, n_lanes, pad_to=16)
    return to_device(lanes, torch.device(device))
