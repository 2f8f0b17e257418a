"""Entropy-model banks for the legacy DCVC family, indexed-rANS mode
(counterpart of dcvc_tpu/entropy/legacy.py).

The pre-UF models (DCVC/TCM/HEM/DC/FM/EVC) code DENSE symbol grids
through CompressAI-lineage CDF groups: per-symbol CDF row index and
per-row integer offset (reference DCVC-family/DCVC-FM/src/models/
entropy_models.py).  Rows are in natural value order (no zig-zag
reorder) and carry an explicit offset.

`_pmf_to_cdf_plain`, `_norm_cdf`, `_laplace_cdf`, LegacyGaussianTable's
`__init__`, `compute_cdf_bank` and `build_indexes_np`,
`legacy_bitparm_bank` and `build_z_indexes` are verbatim copies of the
JAX package's (whose package imports jax), pinned by
tests/test_torch_legacy_entropy.py.

The device-side scale -> row index, `LegacyGaussianTable.build_indexes`,
is the JAX package's f32 formula trunc(clip((log(max(s, 1e-5)) - log_min)
/ step, 0, 255)) computed as a count of thresholds: the f32 bit patterns
at which that formula steps from k - 1 to k (k = 1..255), found by
evaluating the JAX package's build_indexes (XLA, CPU) on every f32 from
half the table's smallest scale to 1.1 times its largest, where it is
monotone and steps by one.  A compare against them is exact on every
device, where a log is not (libm, SLEEF, XLA and CUDA logs differ by an
ulp near some bin edges).  tests/test_torch_legacy_entropy.py re-derives
each threshold from the JAX function.
"""

import functools
import math

import numpy as np
import torch

from .cdf import pmf_to_quantized_cdf

_GAUSSIAN_THRESHOLD_BITS = (
    0x3de6f99a, 0x3decd05f, 0x3df2cced, 0x3df8f039, 0x3dff3b3e, 0x3e02d77f,
    0x3e062641, 0x3e098a69, 0x3e0d0482, 0x3e10951e, 0x3e143ccb, 0x3e17fc1f,
    0x3e1bd3b4, 0x3e1fc426, 0x3e23ce15, 0x3e27f229, 0x3e2c3109, 0x3e308b62,
    0x3e3501e6, 0x3e39954e, 0x3e3e4652, 0x3e4315b2, 0x3e480433, 0x3e4d129e,
    0x3e5241c2, 0x3e579275, 0x3e5d058b, 0x3e629be6, 0x3e68566b, 0x3e6e3601,
    0x3e743b9a, 0x3e7a682d, 0x3e805e5a, 0x3e839d18, 0x3e86f0d7, 0x3e8a5a1f,
    0x3e8dd97a, 0x3e916f76, 0x3e951ca9, 0x3e98e1a6, 0x3e9cbf08, 0x3ea0b56d,
    0x3ea4c576, 0x3ea8efca, 0x3ead3514, 0x3eb19600, 0x3eb61342, 0x3ebaad93,
    0x3ebf65ac, 0x3ec43c4f, 0x3ec93244, 0x3ece4852, 0x3ed37f4b, 0x3ed8d803,
    0x3ede5354, 0x3ee3f21f, 0x3ee9b54c, 0x3eef9dc1, 0x3ef5ac72, 0x3efbe257,
    0x3f012036, 0x3f0463dc, 0x3f07bca2, 0x3f0b2b10, 0x3f0eafb3, 0x3f124b1a,
    0x3f15fdd9, 0x3f19c888, 0x3f1dabbf, 0x3f21a820, 0x3f25be4d, 0x3f29eeeb,
    0x3f2e3aa7, 0x3f32a231, 0x3f37263b, 0x3f3bc77d, 0x3f4086b9, 0x3f4564ab,
    0x3f4a621c, 0x3f4f7fd9, 0x3f54beb1, 0x3f5a1f7c, 0x3f5fa317, 0x3f654a5f,
    0x3f6b163d, 0x3f71079e, 0x3f771f75, 0x3f7d5eba, 0x3f81e339, 0x3f852bcc,
    0x3f88899f, 0x3f8bfd3c, 0x3f8f872e, 0x3f932808, 0x3f96e05d, 0x3f9ab0c7,
    0x3f9e99de, 0x3fa29c43, 0x3fa6b89b, 0x3faaef8d, 0x3faf41c5, 0x3fb3aff8,
    0x3fb83ad3, 0x3fbce314, 0x3fc1a979, 0x3fc68ec5, 0x3fcb93bf, 0x3fd0b938,
    0x3fd5fffc, 0x3fdb68e6, 0x3fe0f4d2, 0x3fe6a4a4, 0x3fec7942, 0x3ff273a2,
    0x3ff894ac, 0x3ffedd60, 0x4002a760, 0x4005f4e9, 0x400957d1, 0x400cd0a6,
    0x40105ff1, 0x40140645, 0x4017c438, 0x401b9a63, 0x401f8961, 0x402391d8,
    0x4027b465, 0x402bf1b5, 0x40304a74, 0x4034bf54, 0x4039510c, 0x403e0055,
    0x4042cdf0, 0x4047baa1, 0x404cc731, 0x4051f46d, 0x40574329, 0x405cb43e,
    0x4062488b, 0x406800f3, 0x406dde65, 0x4073e1c7, 0x407a0c13, 0x40802f23,
    0x40836cb0, 0x4086bf35, 0x408a273c, 0x408da54d, 0x409139f9, 0x4094e5d0,
    0x4098a96a, 0x409c855f, 0x40a07a4f, 0x40a488dd, 0x40a8b1a8, 0x40acf55f,
    0x40b154ae, 0x40b5d04a, 0x40ba68e8, 0x40bf1f47, 0x40c3f423, 0x40c8e843,
    0x40cdfc71, 0x40d3317f, 0x40d8883e, 0x40de0191, 0x40e39e4a, 0x40e95f56,
    0x40ef459e, 0x40f55214, 0x40fb85af, 0x4100f0b7, 0x41043329, 0x41078ab3,
    0x410af7dd, 0x410e7b35, 0x41121548, 0x4115c6b2, 0x41198ffb, 0x411d71c5,
    0x41216cae, 0x41258159, 0x4129b06c, 0x412dfa94, 0x4132607e, 0x4136e2de,
    0x413b826d, 0x41403fe8, 0x41451c0f, 0x414a17ab, 0x414f3389, 0x41547073,
    0x4159cf43, 0x415f50d5, 0x4164f608, 0x416abfc4, 0x4170aef5, 0x4176c48e,
    0x417d0187, 0x4181b370, 0x4184face, 0x41885764, 0x418bc9c2, 0x418f5267,
    0x4192f1eb, 0x4196a8e2, 0x419a77e3, 0x419e5f89, 0x41a26075, 0x41a67b4a,
    0x41aab0af, 0x41af0151, 0x41b36ddf, 0x41b7f70f, 0x41bc9d9d, 0x41c16240,
    0x41c645be, 0x41cb48e0, 0x41d06c72, 0x41d5b145, 0x41db1831, 0x41e0a213,
    0x41e64fcd, 0x41ec2247, 0x41f21a6f, 0x41f83938, 0x41fe7f9c, 0x42027755,
    0x4205c3a7, 0x42092550, 0x420c9cdc, 0x42102ad8, 0x4213cfd5, 0x42178c68,
    0x421b6129, 0x421f4eb5, 0x422355ad, 0x422776b4, 0x422bb275, 0x4230099e,
    0x42347cda, 0x42390ce4, 0x423dba74, 0x4242864b, 0x4247712b, 0x424c7bdf,
    0x4251a733, 0x4256f3fb, 0x425c6312, 0x4261f551, 0x4267ab9f, 0x426d86eb,
    0x42738816, 0x4279b01e, 0x427ffffd,
)
_LAPLACE_THRESHOLD_BITS = (
    0x3c2991a1, 0x3c2f7f82, 0x3c35a276, 0x3c3bfc53, 0x3c428f0f, 0x3c495ca3,
    0x3c506715, 0x3c57b094, 0x3c5f3b4e, 0x3c670983, 0x3c6f1d9f, 0x3c777a0b,
    0x3c8010a3, 0x3c848b00, 0x3c892d72, 0x3c8df95c, 0x3c92f03a, 0x3c981387,
    0x3c9d64d1, 0x3ca2e5b4, 0x3ca897dc, 0x3cae7cff, 0x3cb496e7, 0x3cbae76e,
    0x3cc17079, 0x3cc83404, 0x3ccf341d, 0x3cd672dd, 0x3cddf278, 0x3ce5b535,
    0x3cedbd66, 0x3cf60d7e, 0x3cfea802, 0x3d03c7c3, 0x3d086360, 0x3d0d283d,
    0x3d1217c9, 0x3d173384, 0x3d1c7cfa, 0x3d21f5c2, 0x3d279f84, 0x3d2d7bfb,
    0x3d338ce5, 0x3d39d41d, 0x3d40538a, 0x3d470d1e, 0x3d4e02e5, 0x3d5536fc,
    0x3d5cab8b, 0x3d6462da, 0x3d6c5f37, 0x3d74a310, 0x3d7d30e8, 0x3d8305a7,
    0x3d879a7a, 0x3d8c5851, 0x3d914098, 0x3d9654cc, 0x3d9b9679, 0x3da10732,
    0x3da6a89c, 0x3dac7c70, 0x3db2846c, 0x3db8c264, 0x3dbf383d, 0x3dc5e7ec,
    0x3dccd372, 0x3dd3fcea, 0x3ddb6681, 0x3de3126e, 0x3deb030b, 0x3df33ab7,
    0x3dfbbbf2, 0x3e0244a9, 0x3e06d2bc, 0x3e0b8995, 0x3e106aa4, 0x3e15775d,
    0x3e1ab149, 0x3e201a00, 0x3e25b321, 0x3e2b7e5c, 0x3e317d78, 0x3e37b23f,
    0x3e3e1e92, 0x3e44c468, 0x3e4ba5be, 0x3e52c4a8, 0x3e5a2354, 0x3e61c3f6,
    0x3e69a8dc, 0x3e71d471, 0x3e7a4926, 0x3e8184c5, 0x3e860c24, 0x3e8abc0d,
    0x3e8f95ec, 0x3e949b33, 0x3e99cd6e, 0x3e9f2e2e, 0x3ea4bf0d, 0x3eaa81c2,
    0x3eb07808, 0x3eb6a3a9, 0x3ebd0689, 0x3ec3a294, 0x3eca79c5, 0x3ed18e34,
    0x3ed8e205, 0x3ee07768, 0x3ee850b0, 0x3ef0703c, 0x3ef8d87a, 0x3f00c5fe,
    0x3f0546b2, 0x3f09efb2, 0x3f0ec26b, 0x3f13c050, 0x3f18eae0, 0x3f1e43b4,
    0x3f23cc64, 0x3f298699, 0x3f2f7417, 0x3f3596a5, 0x3f3bf018, 0x3f428267,
    0x3f494f89, 0x3f505986, 0x3f57a28c, 0x3f5f2cc1, 0x3f66fa7c, 0x3f6f0e11,
    0x3f7769ea, 0x3f80084f, 0x3f848261, 0x3f892481, 0x3f8df020, 0x3f92e6ab,
    0x3f9809a4, 0x3f9d5a92, 0x3fa2db1c, 0x3fa88ce6, 0x3fae71a4, 0x3fb48b29,
    0x3fbadb47, 0x3fc163e2, 0x3fc826ff, 0x3fcf26a4, 0x3fd664e8, 0x3fdde40a,
    0x3fe5a645, 0x3fedaded, 0x3ff5fd7f, 0x3ffe9773, 0x4003bf30, 0x40085a82,
    0x400d1f10, 0x40120e47, 0x401729af, 0x401c72cd, 0x4021eb37, 0x4027949f,
    0x402d70b2, 0x40338135, 0x4039c809, 0x40404708, 0x40470029, 0x404df581,
    0x4055291e, 0x405c9d2e, 0x406453fe, 0x406c4fd7, 0x40749323, 0x407d206e,
    0x4082fd22, 0x408791a6, 0x408c4f30, 0x40913726, 0x40964b03, 0x409b8c5a,
    0x40a0fcb8, 0x40a69dc3, 0x40ac7138, 0x40b278d0, 0x40b8b65d, 0x40bf2bce,
    0x40c5db0c, 0x40ccc61c, 0x40d3ef22, 0x40db583c, 0x40e303a6, 0x40eaf3c1,
    0x40f32ae5, 0x40fbab9a, 0x41023c30, 0x4106c9f7, 0x410b8086, 0x4110613f,
    0x41156da4, 0x411aa73e, 0x41200f96, 0x4125a859, 0x412b733a, 0x413171ec,
    0x4137a64c, 0x413e123a, 0x4144b79c, 0x414b987e, 0x4152b6f9, 0x415a1524,
    0x4161b545, 0x416999b1, 0x4171c4b6, 0x417a38dd, 0x41817c5c, 0x4186036d,
    0x418ab306, 0x418f8c96, 0x41949189, 0x4199c36c, 0x419f23d5, 0x41a4b456,
    0x41aa76aa, 0x41b06c90, 0x41b697c8, 0x41bcfa3c, 0x41c395dc, 0x41ca6c9a,
    0x41d18092, 0x41d8d3ec, 0x41e068cf, 0x41e84193, 0x41f0609f, 0x41f8c84f,
    0x4200bd9d, 0x42053e09, 0x4209e6b9, 0x420eb91d, 0x4213b6b7, 0x4218e0f1,
    0x421e3967, 0x4223c1bd, 0x42297b93, 0x422f68a9, 0x42358ada, 0x423be3e3,
    0x424275be, 0x42494272, 0x42504bfa, 0x42579480, 0x425f1e4a, 0x4266eb7c,
    0x426efe83, 0x427759d9, 0x427ffff5,
)
INDEX_THRESHOLDS = {
    "gaussian": np.asarray(_GAUSSIAN_THRESHOLD_BITS, np.int64)
    .astype(np.int32).view(np.float32),
    "laplace": np.asarray(_LAPLACE_THRESHOLD_BITS, np.int64)
    .astype(np.int32).view(np.float32),
}


def _pmf_to_cdf_plain(pmf, tail_mass, pmf_length, max_length):
    """Batched CDF build in natural value order (EntropyCoder.pmf_to_cdf,
    entropy_models.py:25-32): no zig-zag reorder."""
    pmf = np.asarray(pmf, np.float32)
    tail_mass = np.asarray(tail_mass, np.float32).reshape(-1, 1)
    pmf_length = np.asarray(pmf_length).reshape(-1)
    n = pmf.shape[0]
    cdf = np.zeros((n, max_length + 2), dtype=np.int32)
    for i in range(n):
        prob = np.concatenate([pmf[i, :pmf_length[i]], tail_mass[i]])
        row = pmf_to_quantized_cdf(prob)
        cdf[i, :row.shape[0]] = row
    return cdf


def _norm_cdf(x, scale):
    from scipy.special import erf
    return 0.5 * (1.0 + erf(x / (scale * math.sqrt(2.0))))


def _laplace_cdf(x, scale):
    return 0.5 - 0.5 * np.sign(x) * np.expm1(-np.abs(x) / scale)


class LegacyGaussianTable:
    """256-level log-spaced scale table -> quantized CDF rows + offsets.

    distribution: 'laplace' (FM) or 'gaussian' (HEM/DC/TCM/EVC).
    """

    def __init__(self, distribution="gaussian"):
        assert distribution in ("gaussian", "laplace")
        self.distribution = distribution
        if distribution == "laplace":
            self.scale_min, self.scale_max, self.levels = 0.01, 64.0, 256
            self._cdf = _laplace_cdf
        else:
            self.scale_min, self.scale_max, self.levels = 0.11, 64.0, 256
            self._cdf = _norm_cdf
        self.log_scale_min = math.log(self.scale_min)
        self.log_scale_max = math.log(self.scale_max)
        self.log_scale_step = ((self.log_scale_max - self.log_scale_min)
                               / (self.levels - 1))
        self.scale_table = np.exp(np.linspace(
            self.log_scale_min, self.log_scale_max, self.levels))

    def compute_cdf_bank(self):
        """-> (quantized_cdf (levels, L+2) i32, cdf_length i32, offset i32)."""
        scales = self.scale_table
        pmf_center = np.full(self.levels, 50, np.int32)
        for i in range(50, 1, -1):
            probs = self._cdf(np.full_like(scales, float(i)), scales)
            pmf_center = np.where(probs > 0.9999, i, pmf_center)
        pmf_length = 2 * pmf_center + 1
        max_length = int(pmf_length.max())

        samples = (np.arange(max_length, dtype=np.float32)[None, :]
                   - pmf_center[:, None]).astype(np.float32)
        upper = self._cdf(samples + 0.5, scales[:, None])
        lower = self._cdf(samples - 0.5, scales[:, None])
        pmf = upper - lower
        tail_mass = 2 * lower[:, :1]
        cdf = _pmf_to_cdf_plain(pmf, tail_mass, pmf_length, max_length)
        return cdf, (pmf_length + 2).astype(np.int32), (-pmf_center).astype(np.int32)

    def build_indexes_np(self, scales):
        """Host-side scale -> table index (build_indexes,
        entropy_models.py:288-292): truncating int conversion."""
        scales = np.maximum(np.asarray(scales, np.float32), 1e-5)
        idx = (np.log(scales) - self.log_scale_min) / self.log_scale_step
        return np.clip(idx, 0, self.levels - 1).astype(np.int32)

    def build_indexes(self, scales):
        """Device-side variant: the JAX package's f32 formula as the count
        of this table's thresholds at or below each f32 scale.  Returns
        int32 in [0, levels - 1]."""
        s = scales.to(torch.float32)
        return torch.bucketize(s, _thresholds(self.distribution, s.device),
                               right=True).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _thresholds(distribution, device):
    """INDEX_THRESHOLDS[distribution] on `device`, copied there once."""
    return torch.from_numpy(INDEX_THRESHOLDS[distribution]).to(device)


def legacy_bitparm_bank(params, qp_num, channel):
    """Factorized-prior CDF bank in legacy (offset) form.

    params: {h, b: (Q, C, 4), a: (Q, C, 3)} (entropy/bit_estimator.py).
    Mirrors BitEstimator.update (entropy_models.py:141-199): asymmetric
    [−minima, maxima] support, thresholds 1e-4 / 1 − 1e-4, offset=−minima.
    Row index = qp * channel + ch.
    -> (quantized_cdf i32, cdf_length i32, offset i32)
    """
    h = np.asarray(params["h"], np.float32)
    b = np.asarray(params["b"], np.float32)
    a = np.asarray(params["a"], np.float32)
    Q, C = h.shape[:2]
    assert (Q, C) == (qp_num, channel)

    def cdf_net(x):  # x: (Q, C, N)
        x = x.astype(np.float32)
        for i in range(4):
            sp = np.logaddexp(0.0, h[:, :, i:i + 1]).astype(np.float32)
            x = x * sp + b[:, :, i:i + 1]
            if i != 3:
                x = x + np.tanh(x) * np.tanh(a[:, :, i:i + 1])
        return 1.0 / (1.0 + np.exp(-x))

    zeros = np.zeros((Q, C, 1), np.float32)
    minima = np.full((Q, C, 1), 50, np.int32)
    maxima = np.full((Q, C, 1), 50, np.int32)
    for i in range(50, 1, -1):
        lo = cdf_net(zeros - i)
        minima = np.where(lo < 1e-4, i, minima)
        hi = cdf_net(zeros + i)
        maxima = np.where(hi > 1.0 - 1e-4, i, maxima)

    offset = -minima
    pmf_length = maxima + minima + 1
    max_length = int(pmf_length.max())
    samples = (np.arange(max_length, dtype=np.float32)[None, None, :]
               - minima.astype(np.float32))
    lower = cdf_net(samples - 0.5)
    upper = cdf_net(samples + 0.5)
    pmf = upper - lower
    tail_mass = lower[:, :, :1] + (1.0 - upper[:, :, -1:])

    cdf = _pmf_to_cdf_plain(pmf.reshape(-1, max_length),
                            tail_mass.reshape(-1, 1),
                            pmf_length.reshape(-1), max_length)
    return (cdf, (pmf_length.reshape(-1) + 2).astype(np.int32),
            offset.reshape(-1).astype(np.int32))


def build_z_indexes(qp, channel, zh, zw):
    """CHW-order per-channel CDF indexes for a z grid
    (BitEstimator.build_indexes, entropy_models.py:201-204)."""
    idx = np.arange(channel, dtype=np.int16) + qp * channel
    return np.repeat(idx, zh * zw)
