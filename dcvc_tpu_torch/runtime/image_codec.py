"""DMCI inference runtime (counterpart of dcvc_tpu/runtime/image_codec.py).

compress(x, qp) turns an image into the same bit_stream payload as the JAX
codec; decompress(bit_stream, qp, h, w, ec_part) reconstructs from it.

Bit-exactness (the enc/dec contract): the decoder must reproduce the
encoder's priors bit for bit or the stream does not decode.  Both sides
therefore call the very same stage code (`_prior0`, `_step`,
`_synthesis`) on the same device and type, and only exact integer tensors
(z int8, y_q int8, CDF indexes) cross from one side to the other.  Every
kernel on the path is deterministic: the fused DCB kernel has no atomics,
cuDNN runs its deterministic algorithms, and TF32 is off.

Program graph (4-step quadtree ladder):
  enc:  analysis -> prior0 -> { enc_quant_k -> step_k }*4 -> synthesis
  dec:  host z rANS -> prior0 -> { host y rANS -> expand_k -> step_k }*4
        -> synthesis
  dec, device_ec=True: the stream's lanes are copied to the card once;
        then K2 z -> prior0 -> { K2 y -> expand_k -> step_k }*4
        -> synthesis, with K2's lane state threaded on the card and no
        host sync (kernels/rans_decode.py; the symbols are the host
        coder's, so x_hat is the same).
Quantization and entropy bookkeeping run in the quarter-size candidate
domain (core/masks.py); its order is the stream's symbol order.

Host/device overlap (the JAX codec's two halves): compress is
compress_finish(compress_async(x, qp)).  compress_async dispatches the
whole encode and starts the copies of z, of each step's symbols and of
their counts (host_copy.HostCopy), and waits on nothing: the compaction
is sort-based (symbols.py), so no step waits for a count.
compress_finish waits on those copies alone, then runs the host rANS
coder.  compress_many lags the host halves `depth` images behind the
device halves.  A decode is a coroutine (_decompress_gen) that yields
where the host would wait, for an index copy or for its rANS lanes;
decompress runs one, decompress_many round-robins `depth` of them, each
with its own host decoder, so that one image's host work overlaps the
others' device work.  Every call is on the codec's current stream, so
launches and copies keep their order without other events.
"""

import collections

import numpy as np
import torch

from ..core.masks import phase_merge, phase_split, phase_terms_2x, \
    phase_terms_4x, phase_valid, terms_key
from ..core.padding import get_padding_size, pad_replicate_nhwc
from ..entropy.bit_estimator import BitEstimator
from ..entropy.gaussian import GaussianConditional, scale_to_index
from ..kernels.rans_decode import make_bank, rans_decode
from ..models.dmci import DMCI, DMCIConfig
from ..rans.device_decode import init_state, upload_lanes
from ..utils.profiling import count, span, spanned
from .host_copy import HostCopy, to_device
from .symbols import compact_idx_sorted, compact_vals_sorted, \
    expand_from_pos, pack_symbols, quantize_candidate


def set_deterministic():
    """Settings the enc/dec contract needs on the card: deterministic
    cuDNN algorithms, no autotuning, and no TF32 in float32 products."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def check_qp(qp, qp_num):
    # the host coder indexes its CDF banks by qp and does not check
    if not 0 <= int(qp) < qp_num:
        raise ValueError(f"qp {qp} out of range [0, {qp_num})")


def qp_bank(cfg):
    """Rows of a config's per-QP banks: qp_num, or more where the model
    codes shifted QPs past it (DCVC-RT's qp_shift schedule: qp_num +
    EXTRA_QP)."""
    return getattr(cfg, "qp_bank", cfg.qp_num)


def cdf_banks(model, skip_thres):
    """((z_cdf, z_len), (y_cdf, y_len)): the z CDF bank of `model`'s
    bit_estimator_z (from its float32 parameters, whatever dtype the model
    will run in; qp_bank(cfg) rows of ch_z) and the y bank of the Gaussian
    model."""
    cfg = model.cfg
    be = BitEstimator(qp_bank(cfg), cfg.ch_z)
    z = be.compute_cdf_bank(model.bit_estimator_z.bank(), 8)
    return z, GaussianConditional(skip_thres).compute_cdf_bank()


def with_banks(coder, banks):
    """`coder`, a host rANS encoder or decoder, given the (z, y) CDF
    banks."""
    (z_cdf, z_len), (y_cdf, y_len) = banks
    coder.set_cdf(z_cdf, z_len, 0)
    coder.set_cdf(y_cdf, y_len, 1)
    return coder


def make_coders(rans, banks):
    """Host rANS encoder and decoder holding the (z, y) CDF banks."""
    return (with_banks(rans.RansEncoder(), banks),
            with_banks(rans.RansDecoder(), banks))


def device_banks(banks, device):
    """The (z, y) CDF banks as K2's device tensors."""
    return tuple(make_bank(cdf, lengths, device) for cdf, lengths in banks)


def grid_plan(h, w, ch_y, ch_z, device, steps=4):
    """Grid sizes, candidate-domain masks and the z calls' row indexes
    (i % ch_z, for K2) for original size (h, w).  steps=4: the quadtree
    masks (a candidate step has ch_y channels); steps=2: the checkerboard
    masks (2 * ch_y channels)."""
    # frames pad to 16, so the latent grid may be odd (720p -> 45)
    pad_r, pad_b = get_padding_size(h, w, 16)
    yh, yw = (h + pad_b) // 16, (w + pad_r) // 16
    cand = ((yh + 1) // 2, (yw + 1) // 2)
    if steps == 4:
        terms, cand_ch = phase_terms_4x(ch_y), ch_y
    elif steps == 2:
        terms, cand_ch = phase_terms_2x(ch_y), 2 * ch_y
    else:
        raise ValueError(f"steps {steps}: 4 or 2")
    valid = [to_device(phase_valid(yh, yw, terms_key(t)), torch.device(device))
             for t in terms]
    zh, zw = (yh + 3) // 4, (yw + 3) // 4
    z_idx = (torch.arange(zh * zw * ch_z, device=device) % ch_z).to(
        torch.uint8)
    return {"pad": (pad_b, pad_r), "y": (yh, yw), "z": (zh, zw),
            "cand": cand, "cand_ch": cand_ch,
            "n_cand": cand[0] * cand[1] * cand_ch,
            "terms": terms, "valid": valid, "z_idx": z_idx}


def run(gen, on_yield=None):
    """Runs the generator `gen` to its end, calling on_yield() at each of
    its yields; returns its value."""
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value
        if on_yield is not None:
            on_yield()


def lagged(states, finish, depth):
    """[finish(s) for s in states], each finish made once `depth` newer
    states exist (or at the end): the host half of unit k runs while the
    device halves of units k+1..k+depth are queued on the card.  `states`
    is consumed lazily, so each device half is dispatched in turn."""
    pending, results = collections.deque(), []
    for st in states:
        pending.append(st)
        if len(pending) > depth:
            results.append(finish(pending.popleft()))
    while pending:
        results.append(finish(pending.popleft()))
    return results


def encode_stream(encoder, coded, z, qp, ch_z, ec_parallel):
    """One unit's stream from the host rANS `encoder`: the packed symbols
    of each entropy call in reverse call order (dmci_proxy.cpp:838), then
    z (row (i % ch_z) + qp * ch_z of the z bank), on ec_parallel lanes.
    Counts the symbols coded in entropy.symbols."""
    count("entropy.symbols", z.size + sum(c.size for c in coded))
    with span("entropy.encode"):
        encoder.reset()
        encoder.set_parallel(ec_parallel)
        for c in reversed(coded):
            encoder.encode_y(c)
        encoder.encode_z(z.reshape(-1), int(qp) * ch_z, ch_z)
        encoder.flush()
        return encoder.get_encoded_stream()


class EntropyDecoder:
    """The decoder's entropy calls of both codecs, as generators: each
    yields where the host would otherwise wait and returns its result
    (`state, out = yield from ...`; `run` drives one alone).  They use the
    host rANS decoder passed in, or K2 on the card when `device_ec` (then
    the first call takes the stream's lanes, each call threads K2's lane
    state, and nothing waits or yields; a host call's state is None).
    Needs cfg, device, device_ec and _k2_banks."""

    def upload_stream(self, bit_stream, ec_part):
        """device_ec: the stream split into its ec_part lanes and copied to
        the codec's device, (ec_part, L) uint8.  decompress takes it in
        place of the bytes; after it, the decode makes no host sync."""
        return upload_lanes(bit_stream, ec_part, self.device)

    def _decode_z(self, decoder, bit_stream, ec_part, p, qp):
        """The z symbols (1, zh, zw, ch_z) int8 on the codec's device, row
        (i % ch_z) + qp * ch_z of the z bank.  Returns (state, z_int8);
        the host path yields while its lanes decode."""
        ch_z = self.cfg.ch_z
        zh, zw = p["z"]
        n = zh * zw * ch_z
        if self.device_ec:
            if ch_z > 256:     # K2 reads row i % ch_z from uint8 indexes
                raise ValueError(f"device_ec needs ch_z <= 256, got {ch_z}")
            lanes = (bit_stream if isinstance(bit_stream, torch.Tensor)
                     else self.upload_stream(bit_stream, ec_part))
            with span("entropy.decode_z"):
                rows = slice(int(qp) * ch_z, (int(qp) + 1) * ch_z)
                bank = {k: v[rows] for k, v in self._k2_banks[0].items()}
                state, z = rans_decode(init_state(lanes), p["z_idx"], n,
                                       bank)
                return state, z.reshape(1, zh, zw, ch_z)
        with span("entropy.decode_z"):
            decoder.set_parallel(ec_part)
            decoder.set_stream(bit_stream)
            decoder.decode_z(n, int(qp) * ch_z, ch_z)
        yield                          # the lanes decode z meanwhile
        with span("entropy.decode_z"):
            z = to_device(decoder.get_decoded(), self.device)
            return None, z.reshape(1, zh, zw, ch_z)

    def _decode_y(self, decoder, state, packed_idx, count):
        """The y symbols of one call, from the first `count` compacted
        indexes.  Returns (state, symbols int8 on the codec's device): K2
        gives (cap,) with zeros past count, the host coder (count,).  The
        host path copies the indexes and the count to the host (yielding
        while the copy is in flight), starts its lanes (yielding while
        they decode) and copies the symbols back without a wait."""
        if self.device_ec:
            with span("entropy.decode_y"):
                return rans_decode(state, packed_idx, count,
                                   self._k2_banks[1])
        copy = HostCopy(packed_idx, count)
        yield                          # the count / index copy in flight
        idx = copy.finish()
        if idx.size == 0:
            return None, torch.zeros(0, dtype=torch.int8, device=self.device)
        with span("entropy.decode_y"):
            decoder.decode_y(idx)
        yield                          # the lanes decode meanwhile
        with span("entropy.decode_y"):
            return None, to_device(decoder.get_decoded(), self.device)


def ec_parallel_of(rans, total, max_ec, force_ec):
    """The stream's lane count: force_ec where a container pins it for the
    whole sequence (DCVC-RT's SPS), else the coder's choice for `total`
    symbols capped at max_ec."""
    return force_ec or min(rans.compute_ec_parallel(total), max_ec)


class DMCICodec(EntropyDecoder):
    """Holds the model, the CDF banks and the host rANS coders, and
    implements compress/decompress against the bitstream payload.

    params: a state_dict of the class's MODEL_CLS (models.dmci.DMCI,
    reference key names) at a CONFIG_CLS config.  The model runs in
    `dtype` on `device`; on a CUDA device every DepthConvBlock goes
    through the fused CUDA kernel, which takes bfloat16 only.
    compress / decompress code one image; compress_async / compress_finish
    are compress's device and host halves, and compress_many /
    decompress_many overlap several images' halves (module docstring).
    device_ec=True decodes the rANS stream on the device (K2) instead of
    the host coder: same symbols, same x_hat, and no host sync after the
    stream's upload.  Off by default, as in the JAX codec.  force_ec (None
    by default) pins the stream's lane count, as a container with a
    sequence-level lane flag does (DCVC-RT).  spatial_devices (a list of
    devices, None by default): the analysis and the synthesis run in that
    many row tiles, tile i on spatial_devices[i]
    (parallel/spatial.SpatialSplit; dcvc_tpu's spatial_mesh); the priors,
    the decisions and the entropy coding stay whole on `device`."""

    MODEL_CLS = DMCI
    CONFIG_CLS = DMCIConfig
    MAX_EC = 8

    def __init__(self, params, cfg=None, skip_thres=0.0,
                 dtype=torch.bfloat16, device="cuda", device_ec=False,
                 spatial_devices=None):
        set_deterministic()
        self.cfg = cfg or self.CONFIG_CLS()
        self.device = torch.device(device)
        self.dtype = dtype
        self.skip_thres = float(skip_thres)
        # the host coder builds its library with g++ on first import
        from .. import rans
        self._rans = rans
        model = self.MODEL_CLS(self.cfg)
        model.load_state_dict(params)
        banks = cdf_banks(model, skip_thres)
        self._banks = banks
        self.encoder, self.decoder = make_coders(rans, banks)
        # decompress_many's host decoders, one per image in flight
        self._decoders = [self.decoder]
        self.device_ec = bool(device_ec)
        self.force_ec = None
        self._k2_banks = device_banks(banks, self.device)
        self.model = model.to(self.device, dtype).eval()
        self.spatial = None
        if spatial_devices:
            from ..parallel.spatial import SpatialSplit
            self.spatial = SpatialSplit(self.model, spatial_devices)
        self._plans = {}
        # diagnostic symbol capture (cross-platform conformance, as
        # dcvc_tpu's scripts/cross_platform_conformance.py uses it): when
        # a list, compress and decompress append the exact coded symbols
        # of each call, {"z": int8 (n_z,), "y": 4 int8 arrays, "idx": 4
        # uint8 arrays} in the stream's order; None copies nothing and
        # adds no sync
        self.collect_symbols = None

    @classmethod
    def init_random(cls, generator=None, cfg=None, **kwargs):
        """Codec with seeded random weights drawn from `generator` (a CPU
        torch.Generator; seed 0 when None)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cfg = cfg or cls.CONFIG_CLS()
        model = cls.MODEL_CLS(cfg)
        model.reset_parameters(generator)
        return cls(model.state_dict(), cfg=cfg, **kwargs)

    # -------------------------------------------------------------- stages

    def _plan(self, h, w):
        if (h, w) not in self._plans:
            self._plans[(h, w)] = grid_plan(h, w, self.cfg.ch_y,
                                            self.cfg.ch_z, self.device)
        return self._plans[(h, w)]

    def _get_decoder(self, slot):
        """The host rANS decoder of decode slot `slot`: each image in
        flight in decompress_many holds its own stream state."""
        while slot >= len(self._decoders):
            self._decoders.append(with_banks(self._rans.RansDecoder(),
                                             self._banks))
        return self._decoders[slot]

    def _build_idx(self, p, scales, step):
        """Candidate-domain scale indexes + skip conditions + their stable
        compaction (sort-based: no host sync), for mask step `step`."""
        flat = phase_split(scales, p["terms"][step]).float().reshape(-1)
        idx = scale_to_index(flat).to(torch.uint8)
        cond = (flat > self.skip_thres) & p["valid"][step]
        packed_idx, packed_pos, count = compact_idx_sorted(idx, cond)
        return packed_idx, packed_pos, count, cond

    def _analysis(self, p, x, qp):
        """Encoder-only: pad + analysis transform (DMCI: y already scaled by
        its per-QP q_scale_y_enc)."""
        pad_b, pad_r = p["pad"]
        x = pad_replicate_nhwc(x, pad_b, pad_r).to(self.dtype)
        analysis = self.spatial.analysis if self.spatial else \
            self.model.analysis
        y_scaled, z_int8 = analysis(x, qp)
        return y_scaled.float(), z_int8

    def _prior0(self, p, z_int8):
        """Shared enc+dec: hyper prior + step-0 compacted indexes.  Returns
        (means, ctx, packed_idx, packed_pos, count, cond, q): q is what the
        prior gives the quantisation besides (None here; RTIntraCodec's
        hyper-predicted q maps)."""
        scales, means, ctx = self.model.prior0(z_int8, *p["y"])
        return (means, ctx) + self._build_idx(p, scales, 0) + (None,)

    def _enc_y(self, y, q):
        """Encoder-only: the y that is quantised, from _analysis' y and
        _prior0's q (DMCI: y as it is)."""
        return y

    def _enc_quant(self, p, step, y_scaled, means, cond, packed_idx,
                   packed_pos):
        """Encoder-only quantization in the candidate domain; cond and the
        compaction come from the shared prior.  Returns the packed
        (y_q << 8 | index) symbols, compacted, and y_q."""
        terms = p["terms"][step]
        y_c = phase_split(y_scaled, terms)
        m_c = phase_split(means, terms).float()
        y_q = quantize_candidate(y_c, m_c, cond)
        packed_q = compact_vals_sorted(y_q.to(torch.int16).reshape(-1),
                                       packed_pos)
        return pack_symbols(packed_q, packed_idx), y_q

    def _step(self, p, step, y_q_int8, means, y_hat_so_far, ctx):
        """Shared enc+dec ladder rung: merge integer y_q + means into
        y_hat, then the next spatial prior + indexes."""
        terms = p["terms"][step]
        m_c = phase_split(means, terms).float()
        contrib = y_q_int8.float() + m_c
        y_hat_so_far = y_hat_so_far + phase_merge(
            contrib, terms, self.cfg.ch_y, *p["y"])
        if step == 3:
            return y_hat_so_far
        scales, means_next = self.model.prior_step(ctx, y_hat_so_far,
                                                   step + 1)
        return (y_hat_so_far, means_next) + self._build_idx(
            p, scales, step + 1)

    def _synthesis(self, y_hat_so_far, q, qp, h, w):
        """Shared enc+dec reconstruction (q: _prior0's)."""
        synthesis = self.spatial.synthesis if self.spatial else \
            self.model.synthesis
        return synthesis(y_hat_so_far, qp, h, w)

    # -------------------------------------------------------------- encode

    @spanned("codec.compress")
    def compress(self, x, qp):
        """x: (1, H, W, 3) float32 NHWC in [-0.5, 0.5] (unpadded), a numpy
        array or a tensor.

        Returns dict(bit_stream, x_hat, ec_parallel); x_hat is a float32
        tensor on the codec's device."""
        return self.compress_finish(self.compress_async(x, qp))

    @spanned("codec.compress_many")
    def compress_many(self, images, qps, depth=4):
        """compress of each image, the host half of image k made while the
        device halves of images k+1..k+depth are queued on the card.
        Returns the list of results: the serial calls' streams and x_hat."""
        return lagged((self.compress_async(x, qp)
                       for x, qp in zip(images, qps)),
                      self.compress_finish, depth)

    @spanned("codec.compress_async")
    @torch.inference_mode()
    def compress_async(self, x, qp):
        """The device half of compress: dispatches the whole encode and
        starts the copies of z and of each step's symbols and count to the
        host; waits on nothing (given x on the codec's device).  Returns
        the state compress_finish takes."""
        check_qp(qp, self.cfg.qp_num)
        x = torch.as_tensor(x).to(self.device, torch.float32)
        h, w = x.shape[1], x.shape[2]
        p = self._plan(h, w)
        with span("stage.analysis"):
            y, z_int8 = self._analysis(p, x, qp)
        z_copy = HostCopy(z_int8)
        with span("stage.prior"):
            means, ctx, packed_idx, packed_pos, count, cond, q = \
                self._prior0(p, z_int8)
            y_scaled = self._enc_y(y, q)
            y_hat = torch.zeros((1,) + p["y"] + (self.cfg.ch_y,),
                                dtype=torch.float32, device=self.device)
        copies = []
        for k in range(4):
            with span("stage.quant"):
                combined, y_q = self._enc_quant(p, k, y_scaled, means, cond,
                                                packed_idx, packed_pos)
            copies.append(HostCopy(combined, count))
            with span("stage.step"):
                out = self._step(p, k, y_q, means, y_hat, ctx)
            if k < 3:
                y_hat, means, packed_idx, packed_pos, count, cond = out
            else:
                y_hat = out
        with span("stage.synthesis"):
            x_hat = self._synthesis(y_hat, q, qp, h, w)
        return {"z": z_copy, "coded": copies, "qp": int(qp), "x_hat": x_hat}

    @spanned("codec.compress_finish")
    def compress_finish(self, st):
        """The host half of compress: waits on compress_async's copies
        alone, runs the host rANS coder and returns compress's result."""
        coded = [c.finish() for c in st["coded"]]
        z = st["z"].finish()
        if self.collect_symbols is not None:
            self.collect_symbols.append(
                {"z": z.reshape(-1).copy(),
                 "y": [(c >> 8).astype(np.int8) for c in coded],
                 "idx": [(c & 0xFF).astype(np.uint8) for c in coded]})
        ec_parallel = ec_parallel_of(self._rans, sum(c.size for c in coded),
                                     self.MAX_EC, self.force_ec)
        return {"bit_stream": encode_stream(self.encoder, coded, z,
                                            st["qp"], self.cfg.ch_z,
                                            ec_parallel),
                "x_hat": st["x_hat"], "ec_parallel": ec_parallel}

    # -------------------------------------------------------------- decode

    @spanned("codec.decompress")
    @torch.inference_mode()
    def decompress(self, bit_stream, qp, h, w, ec_part):
        """Returns dict(x_hat) with x_hat (1, h, w, 3) float32 in
        [-0.5, 0.5], a tensor on the codec's device.  With device_ec,
        bit_stream may also be upload_stream's lanes."""
        return run(self._decompress_gen(self.decoder, bit_stream, qp, h, w,
                                        ec_part))

    @spanned("codec.decompress_many")
    @torch.inference_mode()
    def decompress_many(self, streams, qps, h, w, ec_parts, depth=10):
        """decompress of each stream, `depth` images in flight: a
        round-robin over their decode coroutines, each with its own host
        decoder, so that one image's index copies and host rANS overlap
        the others' device work (the cross-image form of the reference's
        entropy / graph interleave, dmci_proxy.cpp:423-602).  Returns the
        list of dict(x_hat): the serial calls' frames."""
        jobs = list(zip(streams, qps, ec_parts))
        outs = [None] * len(jobs)
        live, slots, next_i = [], collections.deque(range(depth)), 0
        while live or next_i < len(jobs):
            while slots and next_i < len(jobs):
                slot = slots.popleft()
                decoder = None if self.device_ec else self._get_decoder(slot)
                bs, qp, ec = jobs[next_i]
                live.append((self._decompress_gen(decoder, bs, qp, h, w, ec),
                             slot, next_i))
                next_i += 1
            for job in list(live):
                try:
                    with span("codec.decode_unit"):
                        next(job[0])
                except StopIteration as stop:
                    outs[job[2]] = stop.value
                    live.remove(job)
                    slots.append(job[1])
        return outs

    def _decompress_gen(self, decoder, bit_stream, qp, h, w, ec_part):
        """One image's decode as a coroutine: yields where the host would
        wait (EntropyDecoder's calls) and, on the device path, after each
        rung, having waited on nothing; returns dict(x_hat)."""
        check_qp(qp, self.cfg.qp_num)
        p = self._plan(h, w)
        ch_y = self.cfg.ch_y
        state, z_int8 = yield from self._decode_z(decoder, bit_stream,
                                                  ec_part, p, qp)
        with span("stage.prior"):
            means, ctx, packed_idx, packed_pos, count, _, q = self._prior0(
                p, z_int8)
            y_hat = torch.zeros((1,) + p["y"] + (ch_y,),
                                dtype=torch.float32, device=self.device)
        collect = ({"z": z_int8.cpu().numpy().reshape(-1), "y": [],
                    "idx": []} if self.collect_symbols is not None else None)
        for k in range(4):
            state, decoded = yield from self._decode_y(decoder, state,
                                                       packed_idx, count)
            if collect is not None:
                c = int(count)
                collect["y"].append(decoded[:c].cpu().numpy())
                collect["idx"].append(packed_idx[:c].cpu().numpy())
            with span("stage.step"):
                y_q = expand_from_pos(packed_pos, decoded,
                                      p["n_cand"]).reshape(
                    (1,) + p["cand"] + (ch_y,))
                out = self._step(p, k, y_q, means, y_hat, ctx)
            if k < 3:
                y_hat, means, packed_idx, packed_pos, count, _ = out
            else:
                y_hat = out
            if self.device_ec:
                yield                  # the rung is queued on the card
        if collect is not None:
            self.collect_symbols.append(collect)
        with span("stage.synthesis"):
            return {"x_hat": self._synthesis(y_hat, q, qp, h, w)}
