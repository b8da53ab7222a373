"""
Structure renders on the host (counterpart of
foldingdiff_tpu/metrics/struct_vis.py; reference foldingdiff/pymol_vis.py
without PyMOL): a backbone PDB to a PNG of its CA trace coloured by P-SEA
secondary structure, a batch of them, and a denoising trajectory to a GIF
whose frames are each superposed (Kabsch) onto the last, so the view stays
still (reference pymol_vis.py:93-156).

matplotlib and PIL are optional (the card's machine has neither): they are
imported inside the functions, never when this module is imported.
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

import numpy as np

SS_COLORS = {"a": "#d62728", "b": "#1f77b4", "c": "#7f7f7f"}
PACKAGES = ("matplotlib",)
GIF_PACKAGES = ("matplotlib", "PIL")


def _render_ca(ca: np.ndarray, ss: Optional[np.ndarray], ax, lw: float = 2.0) -> None:
    for i in range(len(ca) - 1):
        color = SS_COLORS.get(ss[i] if ss is not None else "c", "#7f7f7f")
        seg = ca[i : i + 2]
        ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color=color, lw=lw)


def _ca_and_ss(pdb_fname: str):
    from foldingdiff_tpu_torch.geometry.pdb import extract_backbone_coords
    from foldingdiff_tpu_torch.metrics.ss import annotate_sse_ca

    ca = np.asarray(extract_backbone_coords(pdb_fname, atoms=("CA",)))
    return ca, annotate_sse_ca(ca)


def pdb2png(pdb_fname: str, out_fname: str, title: str = "") -> str:
    """Render a backbone PDB to PNG (reference pymol_vis.pdb2png, 50-66)."""
    from foldingdiff_tpu_torch.metrics.plotting import pyplot

    plt = pyplot()
    ca, ss = _ca_and_ss(pdb_fname)
    fig = plt.figure(dpi=150, figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")
    _render_ca(ca, ss, ax)
    ax.set_axis_off()
    ax.set_title(title or os.path.basename(pdb_fname))
    fig.savefig(out_fname, bbox_inches="tight")
    plt.close(fig)
    return out_fname


def pdb2png_batch(pdb_fnames: Sequence[str], out_dir: str) -> List[str]:
    """pdb2png of each file into out_dir/<stem>.png."""
    os.makedirs(out_dir, exist_ok=True)
    return [pdb2png(f, os.path.join(out_dir, os.path.splitext(os.path.basename(f))[0] + ".png"))
            for f in pdb_fnames]


def _superimpose(mobile: np.ndarray, target: np.ndarray) -> np.ndarray:
    from foldingdiff_tpu_torch.eval.tmscore import kabsch

    n = min(len(mobile), len(target))
    rot, t = kabsch(mobile[:n], target[:n])
    return mobile @ rot.T + t


def pdb2gif(pdb_fnames: Sequence[str], out_fname: str, duration_ms: int = 100, stride: int = 1) -> str:
    """
    Animate a denoising trajectory (ordered PDB frames, every stride-th) into
    a GIF, each frame centred and superposed onto the final structure
    (reference pymol_vis.pdb2gif + images_to_gif, 93-156).
    """
    from PIL import Image

    from foldingdiff_tpu_torch.geometry.pdb import extract_backbone_coords
    from foldingdiff_tpu_torch.metrics.plotting import pyplot
    from foldingdiff_tpu_torch.metrics.ss import annotate_sse_ca

    plt = pyplot()
    pdb_fnames = list(pdb_fnames)[::stride]
    coords = [np.asarray(extract_backbone_coords(f, atoms=("CA",))) for f in pdb_fnames]
    final = coords[-1] - coords[-1].mean(axis=0)
    aligned = [_superimpose(c - c.mean(axis=0), final) for c in coords]

    lims = np.concatenate(aligned)
    lo, hi = lims.min(axis=0) - 2, lims.max(axis=0) + 2
    frames = []
    for i, ca in enumerate(aligned):
        fig = plt.figure(dpi=100, figsize=(4, 4))
        ax = fig.add_subplot(projection="3d")
        _render_ca(ca, annotate_sse_ca(ca), ax)
        ax.set(xlim=(lo[0], hi[0]), ylim=(lo[1], hi[1]), zlim=(lo[2], hi[2]))
        ax.set_axis_off()
        ax.set_title(f"frame {i * stride}/{(len(pdb_fnames) - 1) * stride}")
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())
        frames.append(Image.fromarray(buf[:, :, :3]))
        plt.close(fig)
    frames[0].save(out_fname, save_all=True, append_images=frames[1:], duration=duration_ms, loop=0)
    logging.info(f"Wrote {len(frames)}-frame GIF to {out_fname}")
    return out_fname
