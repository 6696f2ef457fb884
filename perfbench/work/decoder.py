"""Operations of the decoders and of the decoder LRP, counted from the
matrix products' shapes (elementwise work left out: a floor)."""

from __future__ import annotations


def consts_flops(s) -> float:
    """The image-side projections of one image."""
    return 2.0 * (s.L * s.D * s.H + s.D * s.E + s.L * s.H * s.H)


def step_flops(s) -> float:
    """One decoder step of one row."""
    E, H, L, V = s.E, s.H, s.L, s.V
    attend = 2.0 * (H * H + L * H + L * H + H * H + H)
    out = 2.0 * H * V
    if s.model == "adaptiveattention":
        return 2.0 * (2 * E * 4 * H + H * 4 * H) + attend + 2.0 * (2 * E * H + H * H) + out
    td = 2.0 * ((H + 2 * E) * 4 * H + H * 4 * H) + 2.0 * ((H + 2 * E) * H + H * H)
    lang = 2.0 * (2 * H * 4 * H + H * 4 * H)
    return td + lang + attend + out


def forward_flops(s, steps: int) -> float:
    """One image's teacher-forced forward over ``steps`` steps."""
    return consts_flops(s) + steps * step_flops(s)


def lrp_word_flops(s, position: int) -> float:
    """The adaptive decoder's LRP of the word at ``position``: the output
    layer, the gate block at each step back to the first, the global and
    the grid projections."""
    E, H, L, D, V = s.E, s.H, s.L, s.D, s.V
    return 2.0 * (H * V + (position + 1) * (2 * E + H) * H + E * D + L * H * D)
