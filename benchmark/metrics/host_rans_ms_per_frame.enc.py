"""Host time inside the host rANS coder's methods (the encoder and
decoder classes of dcvc_tpu_torch.rans) during the traced encode calls,
per frame encoded."""

LAYER = "entropy"
MOVES = "encode_fps"
UNIT = "ms/frame"
KIND = "enc"


def read(trace):
    s = trace.host_coder_s.get(KIND, 0.0)
    if s <= 0 or not trace.frames[KIND]:
        return None
    return 1e3 * s / trace.frames[KIND]
