"""DMC-HTS: the program's DMCHTCodec driven through its public calls,
and the frozen reference beside it.

A request is one closed segment: the DPB cleared and seeded with the
segment's first frame, then its chunks of 8 frames through
compress_sequence; the decode seeds its own DPB the same way and runs
decompress_sequence.  The gate: the decoder's final DPB (reference
feature and memory) equals the encoder's bit for bit.
"""

import torch

from benchmark.reference.dmc_hts import DMCHTS

FRAMES_PER_CHUNK = 8


def reference(spec, numerics=None):
    return DMCHTS(spec["widths"], numerics)


def _chunks(frames):
    return [torch.cat(frames[i:i + FRAMES_PER_CHUNK], dim=-1)
            for i in range(0, len(frames), FRAMES_PER_CHUNK)]


def frames_per_request(workload):
    return FRAMES_PER_CHUNK * workload["request"]["chunks"]


class Program:
    """The program's codec and the calls of one request."""

    def __init__(self, state, spec, workload, device, dtype):
        from dcvc_tpu_torch.models.dmc_ht import DMCHTConfig
        from dcvc_tpu_torch.runtime.video_codec import DMCHTCodec
        self.codec = DMCHTCodec(
            state, cfg=DMCHTConfig(**spec["widths"]), dtype=dtype,
            skip_thres=spec["skip_thres"], device=device,
            device_ec=workload["decode"] == "k2")
        self.h, self.w = workload["height"], workload["width"]

    def prepare(self, frames):
        return {"first": frames[0], "chunks": _chunks(frames)}

    def _seed(self, req):
        self.codec.clear_dpb()
        self.codec.add_ref_feature_from_frame(req["first"])

    def encode(self, req, qp):
        self._seed(req)
        res = self.codec.compress_sequence(req["chunks"],
                                           [qp] * len(req["chunks"]))
        return {"streams": [r["bit_stream"] for r in res],
                "ecs": [r["ec_parallel"] for r in res], "qp": qp,
                "dpb": (self.codec.ref_feature, self.codec.memory)}

    def decode(self, req, enc):
        self._seed(req)
        n = len(enc["streams"])
        frames = self.codec.decompress_sequence(
            enc["streams"], [enc["qp"]] * n, self.h, self.w, enc["ecs"])
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
    outs = model.code_segment(frames[0], _chunks(frames), qp,
                              spec["skip_thres"])
    return torch.cat(outs)


def work_fns(model, workload, spec):
    """(encode, decode) of one request on meta tensors, for the counts."""
    h, w = workload["height"], workload["width"]
    n = workload["request"]["chunks"]
    skip, qp = spec["skip_thres"], 0
    first = torch.zeros(1, h, w, 3, device="meta")
    chunk = torch.zeros(1, h, w, 3 * FRAMES_PER_CHUNK, device="meta")

    def encode():
        ref, memory = model.seed_feature(first), None
        for _ in range(n):
            memory, ctx = model.adapt(ref, memory)
            y, z = model.analysis(chunk, ctx, qp)
            ref = model.feature(y, z, memory, ctx, qp, skip)

    with torch.no_grad():
        ref = model.seed_feature(first)
        memory, ctx = model.adapt(ref, None)
        y, z = model.analysis(chunk, ctx, qp)

    def decode():
        ref, memory = model.seed_feature(first), None
        for _ in range(n):
            memory, ctx = model.adapt(ref, memory)
            ref = model.feature(y, z, memory, ctx, qp, skip)
            model.recon(ref, h, w)

    return encode, decode
