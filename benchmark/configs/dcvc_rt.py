"""DCVC-RT's P-frame codec: the program's DMCRTCodec driven through its
public calls, and the frozen reference beside it.

A request is one closed segment of P frames: the DPB cleared and seeded
with the segment's first frame, then its frames through
compress_sequence, frame i at the module bank shift_qp(qp,
INDEX_MAP[i]), the stream's lanes pinned to the configuration's `lanes`;
the decode seeds its own DPB the same way and runs decompress_sequence.
RT codes frames in [0, 1]: the made frames (in [-0.5, 0.5]) are shifted
by +0.5 for the program and the reference alike.  The gate: the
decoder's final DPB (feature and memory) equals the encoder's bit for
bit.
"""

import torch

from benchmark.reference import counts_rt
from benchmark.reference.dcvc_rt import DMCRT


def reference(spec, numerics=None):
    return DMCRT(spec["widths"], numerics)


def frames_per_request(workload):
    return workload["request"]["frames"]


def _shift(frames):
    return [f + 0.5 for f in frames]


class Program:
    """The program's codec and the calls of one request."""

    def __init__(self, state, spec, workload, device, dtype):
        from dcvc_tpu_torch.legacy.dcvc_rt import DMCRTCodec, DMCRTConfig
        self.codec = DMCRTCodec(
            state, cfg=DMCRTConfig(**spec["widths"]), dtype=dtype,
            skip_thres=spec["skip_thres"], device=device,
            device_ec=workload["decode"] == "k2")
        self.codec.force_ec = spec["lanes"]
        self.qp_num = spec["widths"]["qp_num"]
        self.h, self.w = workload["height"], workload["width"]

    def prepare(self, frames):
        frames = _shift(frames)
        return {"first": frames[0], "frames": frames}

    def _seed(self, req):
        self.codec.clear_dpb()
        self.codec.add_ref_feature_from_frame(req["first"])

    def encode(self, req, qp):
        from dcvc_tpu_torch.legacy.dcvc_rt import INDEX_MAP, shift_qp
        self._seed(req)
        qps = [shift_qp(qp, INDEX_MAP[i % len(INDEX_MAP)], self.qp_num)
               for i in range(len(req["frames"]))]
        res = self.codec.compress_sequence(req["frames"], qps)
        return {"streams": [r["bit_stream"] for r in res],
                "ecs": [r["ec_parallel"] for r in res], "qps": qps,
                "dpb": (self.codec.ref_feature, self.codec.memory)}

    def decode(self, req, enc):
        self._seed(req)
        frames = self.codec.decompress_sequence(
            enc["streams"], enc["qps"], self.h, self.w, enc["ecs"])
        return {"frames": frames,
                "dpb": (self.codec.ref_feature, self.codec.memory)}

    @staticmethod
    def gate(enc, dec):
        return all(torch.equal(a, b) for a, b in zip(enc["dpb"], dec["dpb"]))

    @staticmethod
    def outputs(dec):
        """The decoded frames, (n, h, w, 3)."""
        return torch.cat(dec["frames"])

    @staticmethod
    def stream_bytes(enc):
        return sum(len(s) for s in enc["streams"])


def reference_outputs(model, frames, qp, spec):
    """The reference's decoded frames of the request, (n, h, w, 3)."""
    frames = _shift(frames)
    return torch.cat(model.code_segment(frames[0], frames, qp,
                                        spec["skip_thres"]))


def work_fns(model, workload, spec):
    """(encode, decode) of one request on meta tensors, for the counts;
    each also leaves the bound of the two-way blocks it runs in
    counts_rt.REQUEST_BOUND_MS (the dcb_rt_roofline_share readers)."""
    h, w = workload["height"], workload["width"]
    n = frames_per_request(workload)
    skip, qp = spec["skip_thres"], 0
    frame = torch.zeros(1, h, w, 3, device="meta")

    with torch.no_grad():
        feature = model.adapt(model.seed_feature(frame), True)
        ctx, _ = model.extract(feature, qp)
        y, z = model.analysis(frame, ctx, qp)

    def frames(encode):
        dpb = model.seed_feature(frame)
        for i in range(n):
            feature = model.adapt(dpb, i == 0)
            ctx, ctx_t = model.extract(feature, qp)
            if encode:
                model.analysis(frame, ctx, qp)
            dpb = model.feature(y, z, ctx, ctx_t, qp, skip)
            if not encode:
                model.recon(dpb, qp, h, w)

    def encode():
        counts_rt.REQUEST_BOUND_MS["enc"] = counts_rt.bound_ms(
            model, lambda: frames(True))

    def decode():
        counts_rt.REQUEST_BOUND_MS["dec"] = counts_rt.bound_ms(
            model, lambda: frames(False))

    return encode, decode
