"""Shinnar-Le Roux RF pulse design and Bloch simulation (numpy): the
port's own copy of ``rehrseg_tpu.ops.slr``.

The reference takes its MRI slice-profile blur kernel from the `degrade`
package's ``select_kernel(window, 'rf-pulse-slr', fwhm)``
(utils/blur_kernel_ops.py:3,12-13), which designs an excitation RF pulse
with the Shinnar-Le Roux transform and samples the resulting slice
profile. This module is the standard SLR toolchain (J. Pauly et al.,
"Parameter Relations for the Shinnar-Le Roux Selective Excitation Pulse
Design Algorithm", IEEE TMI 1991):

  dzls   least-squares FIR beta-polynomial design (scipy.signal.firls)
  mag2mp minimum-phase reconstruction via the complex cepstrum
  b2a    alpha polynomial from beta with |a|^2 + |b|^2 = 1
  ab2rf  inverse SLR recursion: Cayley-Klein polynomials -> RF samples
  abrm   forward SLR / Bloch simulation of the slice profile

``slice_profile`` returns |Mxy|(x) for an excitation pulse, the physical
through-plane point-spread function of a 2D multislice acquisition.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import firls


def dinf(d1: float, d2: float) -> float:
    """Pauly's D-infinity: transition width factor for LS filter design."""
    a1, a2, a3 = 5.309e-3, 7.114e-2, -4.761e-1
    a4, a5, a6 = -2.66e-3, -5.941e-1, -4.278e-1
    l10d1 = np.log10(d1)
    l10d2 = np.log10(d2)
    return (a1 * l10d1 ** 2 + a2 * l10d1 + a3) * l10d2 + (a4 * l10d1 ** 2 + a5 * l10d1 + a6)


def dzls(n: int, tb: float, d1: float, d2: float) -> np.ndarray:
    """Least-squares linear-phase beta filter with time-bandwidth ``tb``."""
    di = dinf(d1, d2)
    w = di / tb
    f = np.array([0.0, (1 - w) * (tb / 2), (1 + w) * (tb / 2), n / 2]) / (n / 2)
    m = [1.0, 1.0, 0.0, 0.0]
    wts = [1.0, d1 / d2]
    # firls needs odd numtaps; for even n design n+1 taps and resample the
    # linear-phase filter onto the half-sample-shifted even grid.
    if n % 2 == 0:
        h = firls(n + 1, f, m, weight=wts)
        npad = 8 * (n + 1)
        hf = np.fft.fft(h, npad)
        freqs = np.fft.fftfreq(npad)  # signed cycles/sample
        h = np.real(np.fft.ifft(hf * np.exp(-1j * 2 * np.pi * freqs * 0.5)))[:n]
    else:
        h = firls(n, f, m, weight=wts)
    return h


def mag2mp(x: np.ndarray) -> np.ndarray:
    """Minimum-phase signal whose FFT magnitude equals ``x`` (cepstrum method)."""
    n = x.size
    xl = np.log(np.abs(x) + 1e-16)
    xlf = np.fft.fft(xl)
    xlfp = np.zeros_like(xlf)
    xlfp[0] = xlf[0]
    xlfp[1: n // 2] = 2 * xlf[1: n // 2]
    xlfp[n // 2] = xlf[n // 2]
    return np.exp(np.fft.ifft(xlfp))


def b2a(b: np.ndarray) -> np.ndarray:
    """Minimum-phase alpha polynomial satisfying |a|^2 + |b|^2 = 1 on the circle."""
    n = b.size
    npad = n * 16
    bcp = np.zeros(npad, dtype=complex)
    bcp[:n] = b
    bf = np.fft.fft(bcp)
    bfmax = np.max(np.abs(bf))
    if bfmax >= 1:
        bf = bf / (1e-7 + bfmax)
    afa = mag2mp(np.sqrt(np.maximum(1 - np.abs(bf) ** 2, 0.0)))
    a = np.fft.fft(afa) / npad
    a = a[:n][::-1].copy()
    return a


def ab2rf(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Inverse SLR: recover RF samples from Cayley-Klein polynomials."""
    n = b.size
    rf = np.zeros(n, dtype=complex)
    a = a.astype(complex).copy()
    b = b.astype(complex).copy()
    for ii in range(n - 1, -1, -1):
        cj = np.sqrt(1.0 / (1.0 + np.abs(b[ii] / a[ii]) ** 2))
        sj = np.conj(cj * b[ii] / a[ii])
        theta = np.arctan2(np.abs(sj), cj)
        psi = np.angle(sj)
        rf[ii] = 2 * theta * np.exp(1j * psi)
        if ii > 0:
            at = cj * a + sj * b
            bt = -np.conj(sj) * a + cj * b
            a = at[1: ii + 1]
            b = bt[0: ii]
    return rf


def abrm(rf: np.ndarray, x: np.ndarray):
    """Forward SLR simulation at normalized positions ``x`` (cycles across pulse).

    Returns (a, b, mxy) with mxy = 2 * conj(a) * b (excitation profile).
    """
    g = 2 * np.pi / rf.size
    a = np.ones(x.size, dtype=complex)
    b = np.zeros(x.size, dtype=complex)
    for mm in range(rf.size):
        om = x * g
        phi = np.sqrt(np.abs(rf[mm]) ** 2 + om ** 2)
        phi = np.where(phi == 0, 1e-12, phi)
        nxy = rf[mm] / phi
        nz = om / phi
        av = np.cos(phi / 2) - 1j * nz * np.sin(phi / 2)
        bv = -1j * nxy * np.sin(phi / 2)
        at = av * a - np.conj(bv) * b
        bt = bv * a + np.conj(av) * b
        a, b = at, bt
    mxy = 2 * np.conj(a) * b
    return a, b, mxy


def dzrf_ex(n: int = 128, tb: float = 4.0, d1: float = 0.01, d2: float = 0.01) -> np.ndarray:
    """Design a least-squares excitation pulse (sigpy dzrf ptype='ex', ftype='ls')."""
    bsf = np.sin(np.pi / 4)  # sqrt(1/2): 90-degree excitation scaling
    b = bsf * dzls(n, tb, d1, d2)
    a = b2a(b)
    return ab2rf(a, b)


def slice_profile(n: int = 128, tb: float = 4.0, d1: float = 0.01, d2: float = 0.01,
                  oversample: int = 16):
    """|Mxy| excitation slice profile on a fine spatial grid.

    Returns (x, profile) with x in normalized units (the designed passband
    half-width is ~tb/2) sampled at ``oversample`` points per unit.
    """
    rf = dzrf_ex(n, tb, d1, d2)
    half = tb  # simulate out to 2x the slice half-width: covers stopband decay
    x = np.linspace(-half, half, int(2 * half * oversample) + 1)
    _, _, mxy = abrm(rf, x)
    return x, np.abs(mxy)


def measure_fwhm(x: np.ndarray, y: np.ndarray) -> float:
    """FWHM of a peaked, symmetric-ish profile via linear interpolation."""
    ymax = y.max()
    half = ymax / 2.0
    above = y >= half
    idx = np.where(above)[0]
    lo, hi = idx[0], idx[-1]

    def _interp(i0, i1):
        y0, y1 = y[i0], y[i1]
        if y1 == y0:
            return x[i1]
        t = (half - y0) / (y1 - y0)
        return x[i0] + t * (x[i1] - x[i0])

    x_lo = _interp(lo - 1, lo) if lo > 0 else x[lo]
    x_hi = _interp(hi + 1, hi) if hi < len(y) - 1 else x[hi]
    return float(x_hi - x_lo)
