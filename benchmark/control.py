"""The control of `correct`: the frozen reference computed in float8
e4m3 (the precision step below the configurations' bfloat16), put in
the program's place behind the same calls, so that a run of the harness
with it (run.run_cell(..., control=True)) goes through the very
comparison that decides `correct`.  Readings and tests only: the
benchmark's own runs never build it.
"""

import torch

from benchmark.reference.layers import Numerics


class Control:
    """The Program interface of a configuration module `mod`, coding each
    request with its reference in float8."""

    def __init__(self, mod, state, spec, workload, device, dtype):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.mod, self.spec = mod, spec
        with torch.device(device):
            self.model = mod.reference(spec, Numerics("fp8"))
        self.model.load_state_dict(state)
        self.model.eval()

    def prepare(self, frames):
        return frames

    def encode(self, req, qp):
        with torch.no_grad():
            return {"frames": self.mod.reference_outputs(self.model, req, qp,
                                                         self.spec)}

    def decode(self, req, enc):
        return enc

    @staticmethod
    def gate(enc, dec):
        return True

    @staticmethod
    def outputs(dec):
        return dec["frames"]

    @staticmethod
    def stream_bytes(enc):
        return 0
