"""DMCI: the program's DMCICodec driven through its public calls, and
the frozen reference beside it.

A request is one call of images: compress_many, then decompress_many of
its streams.  The gate: every decoded image equals the encoder's
reconstruction bit for bit.
"""

import torch

from benchmark.reference.dmci import DMCI


def reference(spec, numerics=None):
    return DMCI(spec["widths"], numerics)


def frames_per_request(workload):
    return workload["request"]["images"]


class Program:
    """The program's codec and the calls of one request."""

    def __init__(self, state, spec, workload, device, dtype):
        from dcvc_tpu_torch.models.dmci import DMCIConfig
        from dcvc_tpu_torch.runtime.image_codec import DMCICodec
        self.codec = DMCICodec(
            state, cfg=DMCIConfig(**spec["widths"]), dtype=dtype,
            skip_thres=spec["skip_thres"], device=device,
            device_ec=workload["decode"] == "k2")
        self.h, self.w = workload["height"], workload["width"]

    def prepare(self, frames):
        return {"images": frames}

    def encode(self, req, qp):
        res = self.codec.compress_many(req["images"],
                                       [qp] * len(req["images"]))
        return {"streams": [r["bit_stream"] for r in res],
                "ecs": [r["ec_parallel"] for r in res], "qp": qp,
                "x_hat": [r["x_hat"] for r in res]}

    def decode(self, req, enc):
        n = len(enc["streams"])
        res = self.codec.decompress_many(enc["streams"], [enc["qp"]] * n,
                                         self.h, self.w, enc["ecs"])
        return {"x_hat": [r["x_hat"] for r in res]}

    @staticmethod
    def gate(enc, dec):
        return len(enc["x_hat"]) == len(dec["x_hat"]) and all(
            torch.equal(a, b) for a, b in zip(enc["x_hat"], dec["x_hat"]))

    @staticmethod
    def outputs(dec):
        """The decoded images, (n, h, w, 3)."""
        return torch.cat(dec["x_hat"])

    @staticmethod
    def stream_bytes(enc):
        return sum(len(s) for s in enc["streams"])


def reference_outputs(model, frames, qp, spec):
    """The reference's decoded images of the request, (n, h, w, 3)."""
    return torch.cat([model.code(x, qp, spec["skip_thres"])
                      for x in frames])


def work_fns(model, workload, spec):
    """(encode, decode) of one request on meta tensors, for the counts."""
    h, w = workload["height"], workload["width"]
    n = workload["request"]["images"]
    skip, qp = spec["skip_thres"], 0
    x = torch.zeros(1, h, w, 3, device="meta")
    with torch.no_grad():
        y, z = model.analysis(x, qp)

    def encode():
        for _ in range(n):
            yy, zz = model.analysis(x, qp)
            model.reconstruct(yy, zz, qp, h, w, skip)

    def decode():
        for _ in range(n):
            model.reconstruct(y, z, qp, h, w, skip)

    return encode, decode
