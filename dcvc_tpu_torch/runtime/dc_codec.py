"""DCVC-DC P-frame codec runtime (counterpart of dcvc_tpu/runtime/
dc_codec.py; reference DCVC-family/DCVC-DC/src/models/video_model.py:
425-520).  DC has DCVC-FM's two-stream four-part structure (the
quadtree write grids, the stream order and the payload layout are the
same, common_model.py:142-225), so this is FM's runtime with DC's model
and CDF banks: one-row bitparm banks, z channels ch_n (mv) and ch_16x
(contextual).  q_index runs over the 64-level fine interpolation of the
4 anchors.  The caller maps a frame to its feature adaptor by
INDEX_MAP[frame_idx % 4] (legacy/dcvc_dc.py; the family runner's
INDEX_MAP_DC).
"""

from ..legacy.dcvc_dc import DMCDC, DMCDCConfig
from .fm_codec import DMCFMCodec


class DMCDCCodec(DMCFMCodec):
    """FM's codec on DMCDC; init_random (FM's) clones feature_adaptor_1
    into slots 0 and 2 and scales every `kernel` and `fusion_kernel` leaf
    by init_scale, as dcvc_tpu's DMCDCCodec.init_random does."""

    MODEL_CLS = DMCDC
    CONFIG_CLS = DMCDCConfig
    Z_QP_NUM = 1

    def _z_channels(self):
        return self.cfg.ch_n, self.cfg.ch_16x
