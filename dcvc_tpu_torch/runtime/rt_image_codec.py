"""DCVC-RT intra inference runtime (counterpart of
dcvc_tpu/runtime/rt_image_codec.py).

runtime/image_codec.py's ladder (the same stage code on both sides,
candidate-domain symbols, compaction), with RT's source of the y
quantisation: q_enc / q_dec are hyper-predicted per-position maps that
the shared prior0 gives (DCVC-RT/src/models/common_model.py:63-73), not
per-QP channel vectors, so the encoder scales y by q_enc after prior0 and
synthesis takes q_dec.  The RT container caps the entropy coder's lanes
at 2 (a 1-bit ec_part in the SPS, DCVC-RT/src/utils/stream_helper.py:
148-162).  Frames are RGB in [0, 1].

Reference: DCVC-RT/src/models/image_model.py:116-209 compress /
decompress.
"""

import torch

from ..legacy.rt_intra import DMCIRT, DMCIRTConfig
from .image_codec import DMCICodec


class RTIntraCodec(DMCICodec):
    """params: a state_dict of legacy.rt_intra.DMCIRT.  Decodes through the
    host coder only: the JAX codec's decode has no device path, so
    device_ec=True raises."""

    MODEL_CLS = DMCIRT
    CONFIG_CLS = DMCIRTConfig
    MAX_EC = 2

    def __init__(self, params, cfg=None, skip_thres=0.0,
                 dtype=torch.bfloat16, device="cuda", device_ec=False):
        if device_ec:
            raise ValueError("RTIntraCodec: no device entropy decode (the "
                             "JAX package's RT intra codec has none); "
                             "decode through the host coder")
        super().__init__(params, cfg, skip_thres, dtype, device)

    def _prior0(self, p, z_int8, sync_free=False):
        scales, means, ctx, q_enc, q_dec = self.model.prior0(z_int8, *p["y"])
        return (means, ctx) + self._build_idx(p, scales, 0, sync_free) \
            + ((q_enc, q_dec),)

    def _enc_y(self, y, q):
        return (y * q[0]).float()

    def _synthesis(self, y_hat_so_far, q, qp, h, w):
        return self.model.synthesis(y_hat_so_far, q[1], qp, h, w)
