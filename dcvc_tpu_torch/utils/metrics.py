"""Quality metrics (reference src/utils/metrics.py): numpy PSNR clamped at
99.9 dB, windowed SSIM via FFT convolution, MS-SSIM with the 5-level
standard weights and a reduced 4-level fallback for small frames."""

import numpy as np
from scipy import signal


def calc_psnr(img1, img2, data_range=255.0):
    """PSNR between two numpy arrays, clamped to 99.9 dB."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return 99.9
    psnr = 10 * np.log10((data_range ** 2) / mse)
    return min(psnr, 99.9)


def _fspecial_gauss(size, sigma):
    x, y = np.mgrid[-size // 2 + 1:size // 2 + 1, -size // 2 + 1:size // 2 + 1]
    g = np.exp(-((x ** 2 + y ** 2) / (2.0 * sigma ** 2)))
    return g / g.sum()


def calc_ssim(img1, img2, data_range=255.0):
    """Single-scale SSIM; returns (mean ssim map, contrast-structure map)."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    size, sigma = 11, 1.5
    window = _fspecial_gauss(size, sigma)
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu1 = signal.fftconvolve(img1, window, mode="valid")
    mu2 = signal.fftconvolve(img2, window, mode="valid")
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = signal.fftconvolve(img1 * img1, window, mode="valid") - mu1_sq
    sigma2_sq = signal.fftconvolve(img2 * img2, window, mode="valid") - mu2_sq
    sigma12 = signal.fftconvolve(img1 * img2, window, mode="valid") - mu1_mu2

    ssim_map = (((2 * mu1_mu2 + c1) * (2 * sigma12 + c2))
                / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)))
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    return ssim_map.mean(), cs_map.mean()


def calc_msssim(img1, img2, data_range=255.0):
    """MS-SSIM over 2D arrays.  5 levels by default; frames smaller than
    176 px on a side use the 4-level HM-style fallback (reference
    metrics.py:57-84)."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    if min(img1.shape[0], img1.shape[1]) < 176:
        weights = np.array([0.25, 0.25, 0.25, 0.25])
    else:
        weights = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])
    levels = weights.size

    mssim, mcs = [], []
    for i in range(levels):
        ssim_val, cs = calc_ssim(img1, img2, data_range)
        mssim.append(ssim_val)
        mcs.append(cs)
        if i < levels - 1:
            img1 = _downsample2(img1)
            img2 = _downsample2(img2)

    mssim = np.clip(np.asarray(mssim), 1e-7, None)
    mcs = np.clip(np.asarray(mcs), 1e-7, None)
    return float(np.prod(mcs[:levels - 1] ** weights[:levels - 1])
                 * (mssim[levels - 1] ** weights[levels - 1]))


def _downsample2(img):
    """2x2 average pool with edge crop to even dims."""
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    img = img[:h, :w]
    return (img[0::2, 0::2] + img[0::2, 1::2]
            + img[1::2, 0::2] + img[1::2, 1::2]) / 4.0


def calc_msssim_rgb(img1, img2, data_range=255.0):
    """Average MS-SSIM over the channel dim of (C, H, W) arrays."""
    vals = [calc_msssim(img1[c], img2[c], data_range)
            for c in range(img1.shape[0])]
    return float(np.mean(vals))
