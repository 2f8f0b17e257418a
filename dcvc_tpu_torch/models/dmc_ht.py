"""DMC-HT chunk video codec model, HTS and HTL (counterpart of
dcvc_tpu/models/dmc_ht.py).

Eight frames are coded jointly: the chunk (24 input channels) is 8x
pixel-unshuffled to 1536 channels, fused with a temporal context and
compressed into one y latent (256ch @ /16 of the frame).  Temporal memory
propagates across chunks through the feature adaptors and the feature
extractor; the recon head holds 8 frame-specific decoders.  The variants:
  - HTS (is_hts=True): dcb2 trunks, 4 recon trunk blocks shared by frame
    pairs; the spatial priors emit means only, so all four coding steps
    take their scale indexes from the fused prior and one entropy pass
    codes the whole chunk;
  - HTL (is_hts=False, the DCVC-UF long-chunk width): full-width DCBs
    (I = C), deeper trunks, a 3x3 SubpelConv2x in the decoder, shortcut
    hyper / temporal blocks, no recon trunk; the spatial priors emit
    scales and means, so the coding steps form a 4-rung ladder.

The module tree follows the reference torch DMC (src/models/
video_model_ht.py, HTS structure), so its state_dict keys are the
reference's (the names dcvc_tpu.utils.torch_import.key_fn_dmc_ht gives
the flax params): `encoder.conv1.0.adaptor.weight`,
`hyper_decoder.conv.0.up.conv.0.weight`, `recon_head.conv1.{i}.{m}...`,
`recon_head.conv2.{i}.{m}...`, `recon_head.conv2.{i}.3.weight` (HTL:
`recon_head.conv.{i}.{m}...`, head 1x1 `recon_head.conv.{i}.5.weight`), ...

The stage methods are what the runtime calls; the encoder and the decoder
call the same adaptor / prior0 / prior_step / synthesis_feature /
recon_frames, which keeps their priors and reconstructions bit-identical.
The training forward is not ported yet.
"""

import collections
import dataclasses

import torch
import torch.nn as nn

from ..core.padding import pad_for_y
from ..core.shuffle import pixel_shuffle, pixel_unshuffle
from ..layers.blocks import (
    Conv1x1, Conv3x3, DepthConvBlock, DepthwiseConv3x3, ResidualBlockUpsample,
    ResidualBlockWithStride2, StackedDCB, SubpelConv2x, lecun_init_,
)
from . import common


@dataclasses.dataclass(frozen=True)
class DMCHTConfig:
    is_hts: bool = True
    frame_delay: int = 8
    ch_src_intra: int = 3 * 8 * 8   # 192: one unshuffled frame
    ch_y: int = 256
    ch_z: int = 128
    ch_d: int = 512
    ch_m: int = 512
    ch_recon: int = 256
    qp_num: int = 64
    # trunk depths (DCB counts)
    enc_depth: int = 6
    dec_depth: int = 7
    fa_i_depth: int = 4
    fa_m_depth: int = 6
    fx_depth: int = 5
    recon_shared_depth: int = 1     # HTS conv1 blocks per pair
    recon_depth: int = 3            # per-frame DCBs before the head conv

    @property
    def ch_src_d(self):
        return self.ch_src_intra * self.frame_delay

    @property
    def dcb2(self):
        return self.is_hts


HTS_CONFIG = DMCHTConfig(is_hts=True)
HTL_CONFIG = DMCHTConfig(is_hts=False, enc_depth=7, dec_depth=11,
                         fa_i_depth=3, fa_m_depth=10, fx_depth=2,
                         recon_depth=5)
TINY_HT_CONFIG = DMCHTConfig(is_hts=True, ch_y=16, ch_z=8, ch_d=32,
                             ch_m=32, ch_recon=16, qp_num=8,
                             enc_depth=1, dec_depth=1, fa_i_depth=1,
                             fa_m_depth=1, fx_depth=1, recon_depth=1)
TINY_HTL_CONFIG = DMCHTConfig(is_hts=False, ch_y=16, ch_z=8, ch_d=32,
                              ch_m=32, ch_recon=16, qp_num=8,
                              enc_depth=1, dec_depth=1, fa_i_depth=1,
                              fa_m_depth=1, fx_depth=1, recon_depth=1)


def _head_out(c):
    """Entry of the reference's per-frame recon Sequential that holds the
    1x1 head conv, whatever recon_depth is: 3 for HTS, 5 for HTL."""
    return "3" if c.is_hts else "5"


def _dcb_stack(chs, dcb2):
    """Sequential DepthConvBlocks; chs = [(in, out), ...]."""
    return nn.Sequential(*[DepthConvBlock(ci, co, dcb2=dcb2)
                           for ci, co in chs])


class HTEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = _dcb_stack([(c.ch_src_d + c.ch_d, c.ch_d)]
                                + [(c.ch_d, c.ch_d)] * (c.enc_depth - 1),
                                c.dcb2)
        self.down = Conv3x3(c.ch_d, c.ch_y, stride=2)

    def forward(self, x, ctx, quant_step):
        feature = torch.cat([pixel_unshuffle(x, 8), ctx], dim=-1)
        return self.down(self.conv1(feature) * quant_step)


class HTDecoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        # HTS: a bias-free 1x1; HTL: a 3x3 with bias
        self.up = SubpelConv2x(c.ch_y, c.ch_d,
                               kernel_size=1 if c.is_hts else 3)
        self.conv1 = _dcb_stack([(c.ch_d * 2, c.ch_d)]
                                + [(c.ch_d, c.ch_d)] * (c.dec_depth - 1),
                                c.dcb2)

    def forward(self, y_hat, ctx, quant_step):
        feature = torch.cat([self.up(y_hat), ctx], dim=-1)
        return self.conv1(feature) * quant_step


class HTFeatureAdaptorI(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = _dcb_stack([(c.ch_src_intra, c.ch_m)]
                               + [(c.ch_m, c.ch_m)] * (c.fa_i_depth - 1),
                               c.dcb2)

    def forward(self, x):
        return self.conv(x)


class HTFeatureAdaptorM(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = _dcb_stack([(c.ch_m + c.ch_d, c.ch_m)]
                               + [(c.ch_m, c.ch_m)] * (c.fa_m_depth - 1),
                               c.dcb2)

    def forward(self, memory, feature):
        return self.conv(torch.cat([memory, feature], dim=-1))


class HTFeatureExtractor(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = _dcb_stack([(c.ch_m, c.ch_d)]
                               + [(c.ch_d, c.ch_d)] * (c.fx_depth - 1),
                               c.dcb2)

    def forward(self, x):
        return self.conv(x)


class HTHyperEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        # HTS drops the residual blocks' shortcut, HTL keeps it
        sc = not c.is_hts
        self.conv = nn.Sequential(
            DepthConvBlock(c.ch_y, c.ch_y),
            ResidualBlockWithStride2(c.ch_y, c.ch_y, shortcut=sc),
            ResidualBlockWithStride2(c.ch_y, c.ch_z, shortcut=sc))

    def forward(self, y):
        return self.conv(y)


class HTHyperDecoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        # HTS: no shortcut, bias-free upsamplers; HTL: shortcut, bias
        kw = ({"shortcut": False} if c.is_hts
              else {"shortcut": True, "force_bias": True})
        self.conv = nn.Sequential(
            ResidualBlockUpsample(c.ch_z, c.ch_y, **kw),
            ResidualBlockUpsample(c.ch_y, c.ch_y, **kw),
            DepthConvBlock(c.ch_y, c.ch_y))

    def forward(self, z_hat):
        return self.conv(z_hat)


class HTTemporalPriorEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = ResidualBlockWithStride2(c.ch_d, c.ch_y * 2,
                                             shortcut=not c.is_hts)

    def forward(self, memory, quant):
        return self.conv(memory * quant)


class HTPriorFusion(nn.Module):
    """Three 768-wide DCBs (not dcb2) and a 1x1 conv on the hyper and
    temporal priors."""

    def __init__(self, c):
        super().__init__()
        cy3 = c.ch_y * 3
        self.conv = nn.Sequential(
            *[DepthConvBlock(cy3, cy3) for _ in range(3)],
            Conv1x1(cy3, cy3))

    def forward(self, hyper_params, temporal_params):
        return self.conv(torch.cat([hyper_params, temporal_params], dim=-1))


class HTSpatialPrior(nn.Module):
    """Three DCBs and a 1x1 conv to the means (HTS) or to the scales and
    means (HTL)."""

    def __init__(self, c):
        super().__init__()
        cy2 = c.ch_y * 2
        self.conv = nn.Sequential(
            *[DepthConvBlock(cy2, cy2) for _ in range(3)],
            Conv1x1(cy2, c.ch_y if c.is_hts else cy2))

    def forward(self, x):
        return self.conv(x)


class HTReconHead(nn.Module):
    """The 8 frame-specific decoders (reference video_model_ht.py:215-275)
    run as stacked DCB chains.  HTS: a trunk shared by each frame pair
    (conv1.{pair}.{m}), then per-frame blocks (conv2.{frame}.{m}) and a
    per-frame 1x1 conv to the 192 channels of an unshuffled frame
    (conv2.{frame}.3).  HTL: no trunk, per-frame blocks conv.{frame}.{m}
    and the 1x1 at conv.{frame}.5.  Returns the head outputs
    (F, 1, h, w, 192) of frames rows=(lo, hi), before the pixel shuffle."""

    def __init__(self, c):
        super().__init__()
        head_out = _head_out(c)
        assert c.recon_depth <= int(head_out)
        self.cfg = c
        fd = c.frame_delay
        if c.is_hts:
            self.conv1 = nn.ModuleList(
                nn.Sequential(*[DepthConvBlock(c.ch_d, c.ch_d)
                                for _ in range(c.recon_shared_depth)])
                for _ in range(fd // 2))
        heads = []
        for _ in range(fd):
            blocks = [(str(m), DepthConvBlock(c.ch_d if m == 0 else c.ch_recon,
                                              c.ch_recon))
                      for m in range(c.recon_depth)]
            blocks.append((head_out, Conv1x1(c.ch_recon, c.ch_src_intra)))
            heads.append(nn.Sequential(collections.OrderedDict(blocks)))
        # the reference names the per-frame list conv2 (HTS) or conv (HTL)
        self._per_frame_name = "conv2" if c.is_hts else "conv"
        setattr(self, self._per_frame_name, nn.ModuleList(heads))
        # stack views over the blocks above, one per depth (no parameters)
        self.trunk = ([StackedDCB([self.conv1[i][m] for i in range(fd // 2)])
                       for m in range(c.recon_shared_depth)]
                      if c.is_hts else [])
        self.heads = [StackedDCB([getattr(self.per_frame[i], str(m))
                                  for i in range(fd)])
                      for m in range(c.recon_depth)]

    @property
    def per_frame(self):
        """The per-frame decoders (conv2 or conv)."""
        return getattr(self, self._per_frame_name)

    def forward(self, x, rows=None):
        lo, hi = rows if rows is not None else (0, self.cfg.frame_delay)
        x = x.contiguous()
        if self.cfg.is_hts:
            assert lo % 2 == 0 and hi % 2 == 0, "HTS trunk pairs"
            # every trunk entry reads the same x (a stack stride of 0)
            xt = x.unsqueeze(0).expand((hi - lo) // 2, *x.shape)
            for blk in self.trunk:
                xt = blk(xt, rows=(lo // 2, hi // 2))
            # t0, t0, t1, t1, ...: each pair's trunk output twice
            xh = xt.unsqueeze(1).expand(-1, 2, *xt.shape[1:]).reshape(
                hi - lo, *xt.shape[1:])
        else:
            # every head entry reads the same x (a stack stride of 0)
            xh = x.unsqueeze(0).expand(hi - lo, *x.shape)
        for blk in self.heads:
            xh = blk(xh, rows=(lo, hi))
        head_out = _head_out(self.cfg)
        return torch.stack([getattr(self.per_frame[lo + s], head_out)(xh[s])
                            for s in range(hi - lo)])


class DMCHT(nn.Module):
    """Chunk-based video codec, HTS or HTL structure (reference DMC,
    video_model_ht.py:320-527)."""

    def __init__(self, cfg=HTS_CONFIG):
        super().__init__()
        c = self.cfg = cfg
        self.feature_adaptor_i = HTFeatureAdaptorI(c)
        self.feature_adaptor_m = HTFeatureAdaptorM(c)
        self.feature_extractor = HTFeatureExtractor(c)
        self.encoder = HTEncoder(c)
        self.hyper_encoder = HTHyperEncoder(c)
        self.hyper_decoder = HTHyperDecoder(c)
        self.temporal_prior_encoder = HTTemporalPriorEncoder(c)
        self.y_prior_fusion = HTPriorFusion(c)
        self.y_spatial_prior_reduction = Conv1x1(c.ch_y * 3, c.ch_y)
        self.y_spatial_prior_adaptor_1 = DepthConvBlock(
            c.ch_y * 2, c.ch_y * 2, force_adaptor=True)
        self.y_spatial_prior_adaptor_2 = DepthConvBlock(
            c.ch_y * 2, c.ch_y * 2, force_adaptor=True)
        self.y_spatial_prior_adaptor_3 = DepthConvBlock(
            c.ch_y * 2, c.ch_y * 2, force_adaptor=True)
        self.y_spatial_prior = HTSpatialPrior(c)
        self.decoder = HTDecoder(c)
        self.recon_head = HTReconHead(c)
        q = (c.qp_num, c.ch_d)
        self.q_encoder = nn.Parameter(torch.zeros(q))
        self.q_decoder = nn.Parameter(torch.zeros(q))
        self.q_feature = nn.Parameter(torch.zeros(q))
        self.bit_estimator_z = common.BitEstimatorModule(c.qp_num, c.ch_z)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Seeded random init as dcvc_tpu's DMCHT.init does it: lecun-normal
        convs with zero biases (the recon head's depthwise kernels N(0,
        0.02), as its stacked leaves are), the log-spaced q_encoder /
        q_decoder ladders, q_feature ones, and N(0, 0.01) z prior banks.
        Draws from `generator` (a CPU torch.Generator)."""
        lecun_init_(self, generator)
        for m in self.recon_head.modules():
            if isinstance(m, DepthwiseConv3x3):
                m.weight.normal_(0.0, 0.02, generator=generator)
        c = self.cfg
        self.q_encoder.copy_(common.q_ladder_init(0.5, 2.0, c.qp_num, c.ch_d))
        self.q_decoder.copy_(common.q_ladder_init(0.5, 2.0, c.qp_num, c.ch_d,
                                                  inverse=True))
        self.q_feature.fill_(1.0)
        for p in self.bit_estimator_z.parameters():
            p.copy_(0.01 * torch.randn(p.shape, generator=generator))

    @property
    def dtype(self):
        return self.q_encoder.dtype

    def _q(self, table, qp):
        """(qp_num, C) table -> the (C,) row of `qp`."""
        return table[int(qp)]

    # ----------------------------------------------------- temporal state

    def adaptor_i(self, ref_feature):
        """First chunk after a refresh: memory from the intra feature."""
        memory = self.feature_adaptor_i(ref_feature.to(self.dtype))
        return memory, self.feature_extractor(memory)

    def adaptor_m(self, memory, ref_feature):
        memory = self.feature_adaptor_m(memory.to(self.dtype),
                                        ref_feature.to(self.dtype))
        return memory, self.feature_extractor(memory)

    def reset_feature(self, feature):
        """The last frame's recon-head output, unclipped, in the model
        dtype: the new DPB seed (video_model_ht.py:406-411).  Only the last
        frame (HTS: the last frame pair, whose trunk it shares) is
        evaluated; entries of the stack are independent, so that equals
        the full head's last entry bit for bit."""
        fd = self.cfg.frame_delay
        lo = fd - 2 if self.cfg.is_hts else fd - 1
        return self.recon_head(feature.to(self.dtype), rows=(lo, fd))[-1]

    # ------------------------------------------------------ shared stages

    def prior0(self, z_int8, memory, qp, yh, yw):
        """Shared enc/dec: fused prior -> (q_enc, q_dec, scales, means,
        spatial context).  The hyper output lives on the 4-aligned grid;
        it is cropped to the temporal prior's (y) grid BEFORE the fusion
        (reference crop_hyper_params)."""
        temporal = self.temporal_prior_encoder(memory.to(self.dtype),
                                               self._q(self.q_feature, qp))
        hyper = self.hyper_decoder(z_int8.to(self.dtype))[
            :, :temporal.shape[1], :temporal.shape[2], :]
        params = self.y_prior_fusion(hyper, temporal)[:, :yh, :yw, :]
        q_enc, q_dec, scales, means = common.separate_prior_video_infer(
            params)
        ctx = self.y_spatial_prior_reduction(params)
        return q_enc, q_dec, scales, means, ctx

    def prior_step(self, ctx, y_hat_so_far, step):
        """Spatial prior for step k in {1, 2, 3}: the means (HTS) or
        (scales, means) (HTL).  Shared enc/dec."""
        adaptor = (self.y_spatial_prior_adaptor_1,
                   self.y_spatial_prior_adaptor_2,
                   self.y_spatial_prior_adaptor_3)[step - 1]
        sp_in = torch.cat([y_hat_so_far.to(self.dtype), ctx], dim=-1)
        out = self.y_spatial_prior(adaptor(sp_in))
        if self.cfg.is_hts:
            return out
        return tuple(out.chunk(2, dim=-1))

    def analysis(self, x, ctx, qp):
        """Padded chunk (1, H, W, 3 * frame_delay) -> (y, z_int8).  y may
        sit on an odd grid; only the stride-2 hyper path needs
        4-alignment, so y is replicate-padded for it alone."""
        y = self.encoder(x, ctx, self._q(self.q_encoder, qp))
        z = self.hyper_encoder(pad_for_y(y))
        z_int8 = torch.clamp(torch.round(z.float()), -128, 127).to(torch.int8)
        return y, z_int8

    def synthesis_feature(self, y_hat, ctx, qp):
        """Final y_hat (already * q_dec) -> decoder feature, the DPB state.
        The encoder stops here (the reference encode keeps a
        feature-domain DPB and never runs the recon heads)."""
        return self.decoder(y_hat.to(self.dtype), ctx,
                            self._q(self.q_decoder, qp))

    def recon_frames(self, feature, qp, out_h, out_w):
        """Decode-side: recon heads -> frames (F, out_h, out_w, 3) float32
        in [-0.5, 0.5], pixel-shuffled in torch channel order."""
        del qp  # the recon heads do not depend on the QP
        out = self.recon_head(feature.to(self.dtype))
        x = torch.clamp(pixel_shuffle(out[:, 0], 8).float(), -0.5, 0.5)
        return x[:, :out_h, :out_w, :]
