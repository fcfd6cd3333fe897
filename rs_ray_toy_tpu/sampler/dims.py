"""Centralized sampler dimension layout (one table per integrator).

The reference consumes sampler dimensions sequentially per path
(path.rs:51-226); the wavefront build instead assigns *static slots* so
every lane reads the same dimension at the same program point.  Slot
discipline (enforced by tests/test_sampler_dims.py):

1. A slot is consumed by exactly ONE of get_1d / get_2d — never both.
   (With the stratified sampler both calls derive from the same stratum
   permutation, so sharing a slot correlates the two values; round-1
   had this bug in the path BSSRDF block.)
2. A slot is consumed at most once per camera sample.
3. The Halton sampler maps slot d -> radical-inverse dims (2d, 2d+1)
   for BOTH call kinds (get_1d uses only 2d), so distinct slots are
   provably disjoint in the Halton sequence as well.

Global slots
------------
0: camera film jitter (2d)         samplers/mod.rs:28-34
1: camera lens uv     (2d)
2-7: reserved (camera time, future)
8+: integrator blocks below.

Path integrator (integrators/path.py)
-------------------------------------
Per-bounce block of PATH_DPB slots starting at path_dim0(bounce).
Offsets (kind):
  +0 NEE light pick (1d)     } uniform_sample_one_light,
  +1 NEE light sample (2d)   } integrator/mod.rs:359-401
  +2 NEE BSDF counter-sample (2d)
  +3 BSDF sampling (2d)           path.rs:126
  +4 Russian roulette (1d)        path.rs:212-222
  +5 BSSRDF axis/channel probe (1d)   bssrdf.rs sample_s
  +6 BSSRDF disk sample (2d)
  +7 BSSRDF exit NEE light pick (1d)
  +8 BSSRDF exit NEE light sample (2d)
  +9 BSSRDF exit direction (2d)
  +10 spare

VolPath (integrators/volpath.py): per-bounce block of VOLPATH_DPB.
  +0 light pick (1d)  +1 light (2d)  +2 scatter counter (2d)
  +3 phase/BSDF next direction (2d)  +4 RR (1d)
  (medium distance sampling uses the hash stream, not slots)

SPPM (integrators/sppm.py): camera pass uses the path-style block
  +0..+2 direct light, +5 BSDF next (2d), +6 RR (1d).

Debug/DirectLighting (integrators/direct.py): dim_base = 8 + branch*257
is *traced* (per-ray branch salt), so samplers fall back to the hash
RNG stream — no static slots to collide.
"""

INTEGRATOR_DIM0 = 8  # dims 0-7 reserved for the camera sample

# --- path integrator per-bounce block ---
PATH_DPB = 11
PATH_NEE = 0  # +0 (1d), +1 (2d), +2 (2d) consumed by uniform_sample_one_light
PATH_BSDF = 3  # 2d
PATH_RR = 4  # 1d
PATH_BSS_PROBE_1D = 5  # 1d
PATH_BSS_PROBE_2D = 6  # 2d
PATH_BSS_PICK = 7  # 1d
PATH_BSS_LIGHT = 8  # 2d
PATH_BSS_OUT = 9  # 2d


def path_dim0(bounce: int) -> int:
    return INTEGRATOR_DIM0 + bounce * PATH_DPB


# --- volpath per-bounce block ---
VOLPATH_DPB = 8
VOL_NEE = 0  # +0 (1d), +1 (2d), +2 (2d)
VOL_NEXT = 3  # 2d
VOL_RR = 4  # 1d


def volpath_dim0(bounce: int) -> int:
    return INTEGRATOR_DIM0 + bounce * VOLPATH_DPB


# --- sppm camera pass per-depth block ---
SPPM_DPB = 8
SPPM_NEE = 0  # +0 (1d), +1 (2d), +2 (2d)
SPPM_BSDF = 5  # 2d
SPPM_RR = 6  # 1d


def sppm_dim0(depth: int) -> int:
    return INTEGRATOR_DIM0 + depth * SPPM_DPB
