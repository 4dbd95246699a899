"""MFCC audio frontend (PyTorch counterpart of ``eamm_tpu/ops/mfcc.py``).

python_speech_features defaults as the reference calls them: 16 kHz,
25 ms frames every 10 ms, rectangular window, pre-emphasis 0.97, a 512-point
power spectrum, 26 mel filters, log, orthonormal DCT-II keeping 13
cepstra, lifter 22, and cepstrum 0 replaced by the log frame energy.  The
clip is padded with 1920 zeros on each side and cut into one window of
28 MFCC rows x 12 cepstra (cepstrum 0 dropped) per video frame.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

SAMPLE_RATE = 16000
PAD_SAMPLES = 1920      # zeros before and after the clip
WIN_LEN = 400           # 25 ms at 16 kHz
WIN_STEP = 160          # 10 ms at 16 kHz
NFFT = 512
NFILT = 26
NUMCEP = 13
CEPLIFTER = 22
_EPS32 = float(np.finfo(np.float32).eps)


def _hz2mel(hz):
    return 2595.0 * np.log10(1.0 + hz / 700.0)


def _mel2hz(mel):
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(nfilt: int = NFILT, nfft: int = NFFT,
                   samplerate: int = SAMPLE_RATE) -> np.ndarray:
    """[nfilt, nfft // 2 + 1] triangular mel filters over integer FFT bins."""
    melpoints = np.linspace(_hz2mel(0.0), _hz2mel(samplerate / 2), nfilt + 2)
    bins = np.floor((nfft + 1) * _mel2hz(melpoints) / samplerate)
    fbank = np.zeros((nfilt, nfft // 2 + 1), dtype=np.float64)
    for j in range(nfilt):
        lo, mid, hi = bins[j], bins[j + 1], bins[j + 2]
        for i in range(int(lo), int(mid)):
            fbank[j, i] = (i - lo) / (mid - lo)
        for i in range(int(mid), int(hi)):
            fbank[j, i] = (hi - i) / (hi - mid)
    return fbank.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dct_matrix(n_in: int = NFILT, n_out: int = NUMCEP) -> np.ndarray:
    """[n_in, n_out] orthonormal DCT-II (scipy ``dct(type=2, norm='ortho')``)."""
    k = np.arange(n_out)[None, :]
    n = np.arange(n_in)[:, None]
    scale = np.full((n_out,), np.sqrt(2.0 / n_in))
    scale[0] = np.sqrt(1.0 / n_in)
    mat = np.cos(np.pi * k * (2.0 * n + 1) / (2.0 * n_in)) * scale[None, :]
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def lifter_taps(numcep: int = NUMCEP, lifter: int = CEPLIFTER) -> np.ndarray:
    n = np.arange(numcep)
    return (1.0 + (lifter / 2.0) * np.sin(np.pi * n / lifter)).astype(np.float32)


def num_mfcc_frames(n_samples: int) -> int:
    """Frames python_speech_features cuts from ``n_samples`` samples."""
    if n_samples <= WIN_LEN:
        return 1
    return 1 + int(np.ceil((n_samples - WIN_LEN) / float(WIN_STEP)))


def num_windows(n_mfcc_frames: int) -> int:
    """Per-video-frame windows cut from ``n_mfcc_frames`` MFCC rows."""
    return max(0, n_mfcc_frames // 4 - 6)


def _upload_tables(device: torch.device) -> tuple:
    return tuple(torch.from_numpy(t).to(device)
                 for t in (mel_filterbank(), dct_matrix(), lifter_taps()))


_cached_tables = functools.lru_cache(maxsize=None)(_upload_tables)


def _tables(device: torch.device) -> tuple:
    """The filterbank, DCT and lifter on ``device``, uploaded once (an
    upload from pageable memory would wait for the device's queue); while
    ``torch.export`` traces, made anew as program constants, since a tensor
    of the trace must not enter the cache."""
    if torch.compiler.is_compiling():
        return _upload_tables(device)
    return _cached_tables(device)


def _mfcc_from_emph(emph: torch.Tensor, nframes: int) -> torch.Tensor:
    """Pre-emphasized samples (at least ``(nframes - 1) * WIN_STEP +
    WIN_LEN`` of them) -> [nframes, 13] MFCC rows.  Row r reads
    emph[r * WIN_STEP : r * WIN_STEP + WIN_LEN] and nothing else, so rows
    computed from a slice equal those of the whole signal."""
    fbank, dct, lifter = _tables(emph.device)
    frames = emph.unfold(0, WIN_LEN, WIN_STEP)[:nframes]
    spec = torch.fft.rfft(frames, n=NFFT, dim=1)
    pspec = (spec.real ** 2 + spec.imag ** 2) / NFFT
    energy = pspec.sum(dim=1)
    energy = torch.where(energy == 0, _EPS32, energy)
    feat = pspec @ fbank.T
    feat = torch.log(torch.where(feat == 0, _EPS32, feat))
    feat = feat @ dct
    feat = feat * lifter
    feat[:, 0] = torch.log(energy)
    return feat


def _pre_emphasis(x: torch.Tensor) -> torch.Tensor:
    """x[t] - 0.97 x[t - 1] for t >= 1 (x[0] is the sample before)."""
    return x[1:] - 0.97 * x[:-1]


def mfcc(signal: torch.Tensor) -> torch.Tensor:
    """[N] signal -> [num_mfcc_frames(N), 13] float32 MFCC rows."""
    signal = signal.float()
    n = signal.shape[0]
    emph = torch.cat([signal[:1], _pre_emphasis(signal)])
    nframes = num_mfcc_frames(n)
    padlen = (nframes - 1) * WIN_STEP + WIN_LEN
    emph = torch.nn.functional.pad(emph, (0, max(0, padlen - n)))
    return _mfcc_from_emph(emph, nframes)


def mfcc_windows(feats: torch.Tensor) -> torch.Tensor:
    """[M, 13] MFCC rows -> [T, 28, 12]: window t holds rows 4t .. 4t+27
    without cepstrum 0."""
    T = num_windows(feats.shape[0])
    return feats.unfold(0, 28, 4)[:T, 1:].transpose(1, 2)


def audio_to_mfcc_windows(signal: torch.Tensor) -> torch.Tensor:
    """Raw 16 kHz [N] signal -> [T, 28, 12] windows, zero padding included."""
    padded = torch.nn.functional.pad(signal.float(), (PAD_SAMPLES, PAD_SAMPLES))
    return mfcc_windows(mfcc(padded))


def num_windows_for_samples(n_samples: int) -> int:
    """Windows ``audio_to_mfcc_windows`` makes from ``n_samples`` samples."""
    return num_windows(num_mfcc_frames(n_samples + 2 * PAD_SAMPLES))


def min_samples_for_windows(t: int) -> int:
    """Fewest raw samples that give at least ``t`` windows."""
    m = 4 * (t + 6)                  # num_windows(M) >= t  <=>  M >= 4 (t + 6)
    n = WIN_LEN + (m - 2) * WIN_STEP + 1 - 2 * PAD_SAMPLES
    while num_windows_for_samples(n) < t:       # guard the ceil boundary
        n += WIN_STEP
    return n


# A chunk of K windows from window t0 reads MFCC rows 4 t0 .. 4 (t0 + K) + 23,
# so one contiguous slice of the padded signal of a length fixed by K, plus
# the sample before it for the pre-emphasis (zero at the clip start, where
# the rule y[0] = x[0] gives the same on the zero pad).  Over one zero-padded
# buffer the chunks' windows are the whole clip's: every step after the
# pre-emphasis is row-local.

def chunk_samples_len(k_windows: int) -> int:
    """Samples a ``mfcc_window_chunk`` of ``k_windows`` windows reads."""
    return (4 * k_windows + 23) * WIN_STEP + WIN_LEN


def chunk_sample_start(t0: int) -> int:
    """Offset in the padded buffer of the chunk starting at window ``t0``."""
    return 4 * t0 * WIN_STEP


def padded_buffer_len(n_windows: int) -> int:
    """Length of a padded buffer that holds the chunks of ``n_windows``."""
    return chunk_sample_start(n_windows) + chunk_samples_len(0)


def mfcc_window_chunk(samples: torch.Tensor, prev_sample,
                      k_windows: int) -> torch.Tensor:
    """[chunk_samples_len(K)] samples of the padded buffer, and the sample
    before them (a number or a 1-element tensor) -> [K, 28, 12] windows,
    the matching rows of ``audio_to_mfcc_windows`` on that buffer."""
    samples = samples.float()
    prev = torch.as_tensor(prev_sample, dtype=torch.float32,
                           device=samples.device).reshape(1)
    emph = _pre_emphasis(torch.cat([prev, samples]))
    return mfcc_windows(_mfcc_from_emph(emph, 4 * k_windows + 24))
