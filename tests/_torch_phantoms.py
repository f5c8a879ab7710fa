"""The phantoms of tests/test_phantom_neuron.py, without jax.

Verbatim copies of `branching_neuron_phantom`, `crossing_tubes_phantom`,
`branching_neuron_phantom_2d`, `multi_neuron_soma_phantom` and
`snr_phantom`: that module imports the JAX package, and the card's
machine has no jax. `chip_smoke.py` imports them from here (with
`tests/` on `sys.path`); tests/test_torch_yardstick.py holds each copy
bitwise to its original. Each returns (volume uint8, gold SWC rows), and
`snr_phantom` also the SNR.
"""

import numpy as np


def branching_neuron_phantom(shape=(16, 72, 96), radius=2.2, zdist=2.0, seed=2):
    """Y-shaped neurite: trunk along +x, two branches at ~30 degrees.

    Returns (volume uint8, gold SWC rows)."""
    rng = np.random.default_rng(seed)
    pts = []
    # trunk: x in [8, 48] at y=36, z=8
    for t in np.linspace(0, 1, 60):
        pts.append((8 + 40 * t, 36.0, 8.0))
    # branch A: up-right
    for t in np.linspace(0, 1, 50):
        pts.append((48 + 38 * t, 36 + 20 * t, 8.0))
    # branch B: down-right
    for t in np.linspace(0, 1, 50):
        pts.append((48 + 38 * t, 36 - 20 * t, 8.0))
    pts = np.asarray(pts)

    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    vol = np.zeros(shape)
    for px, py, pz in pts:
        d2 = (x - px) ** 2 + (y - py) ** 2 + ((z - pz) * zdist) ** 2
        np.maximum(vol, np.exp(-d2 / (2 * radius**2)), out=vol)
    intensity = 190.0 * (0.75 + 0.25 * np.sin(x / 5.0))
    vol = np.clip(vol * intensity + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)

    gold = []
    for i, (px, py, pz) in enumerate(pts, start=1):
        if i == 1:
            parent = -1
        elif i == 111:  # branch B roots at the trunk tip, not branch A's end
            parent = 60
        else:
            parent = i - 1
        gold.append([i, 2, px, py, pz, radius, parent])
    return vol, np.asarray(gold, np.float64)


def crossing_tubes_phantom(shape=(16, 80, 96), radius=2.2, zdist=2.0, seed=9):
    """Two straight neurites crossing in the xy plane (~45 degrees) —
    the intersection stresses density suppression and direction priors
    (a trace must pass straight through the other tube's bright blob).

    Returns (volume uint8, gold SWC rows: two independent polylines)."""
    rng = np.random.default_rng(seed)
    pts = []
    # tube A: from (10, 20) to (86, 60); tube B: from (10, 60) to (86, 20)
    for t in np.linspace(0, 1, 70):
        pts.append((10 + 76 * t, 20 + 40 * t, 8.0))
    for t in np.linspace(0, 1, 70):
        pts.append((10 + 76 * t, 60 - 40 * t, 8.0))
    pts = np.asarray(pts)

    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    vol = np.zeros(shape)
    for px, py, pz in pts:
        d2 = (x - px) ** 2 + (y - py) ** 2 + ((z - pz) * zdist) ** 2
        np.maximum(vol, np.exp(-d2 / (2 * radius**2)), out=vol)
    intensity = 190.0 * (0.75 + 0.25 * np.sin(x / 5.0))
    vol = np.clip(vol * intensity + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)

    gold = []
    for i, (px, py, pz) in enumerate(pts, start=1):
        parent = -1 if i in (1, 71) else i - 1
        gold.append([i, 2, px, py, pz, radius, parent])
    return vol, np.asarray(gold, np.float64)


def branching_neuron_phantom_2d(shape=(1, 80, 112), radius=2.2, seed=5):
    """The Y-phantom flattened to a single slice (the reference's P==1
    first-class 2-D path, Advantra_plugin.cpp:2339 / frangi2d)."""
    rng = np.random.default_rng(seed)
    pts = []
    for t in np.linspace(0, 1, 60):
        pts.append((10 + 44 * t, 40.0, 0.0))
    for t in np.linspace(0, 1, 50):
        pts.append((54 + 44 * t, 40 + 24 * t, 0.0))
    for t in np.linspace(0, 1, 50):
        pts.append((54 + 44 * t, 40 - 24 * t, 0.0))
    pts = np.asarray(pts)

    _, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    vol = np.zeros(shape)
    for px, py, _pz in pts:
        d2 = (x - px) ** 2 + (y - py) ** 2
        np.maximum(vol, np.exp(-d2 / (2 * radius**2)), out=vol)
    intensity = 190.0 * (0.75 + 0.25 * np.sin(x / 5.0))
    vol = np.clip(vol * intensity + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)

    gold = []
    for i, (px, py, pz) in enumerate(pts, start=1):
        if i == 1:
            parent = -1
        elif i == 111:
            parent = 60
        else:
            parent = i - 1
        gold.append([i, 2, px, py, pz, radius, parent])
    return vol, np.asarray(gold, np.float64)


def multi_neuron_soma_phantom(shape=(20, 96, 128), zdist=2.0, seed=21):
    """Two neurons, each a bright soma blob with two neurites of
    DIFFERENT radii leaving it. Gates the full soma path at quality
    level (the unit tests only check detection): erode/threshold/CC
    soma extraction, seed suppression inside the soma mask, the
    trackPos soma-hit link (traces walking INTO a soma must stop and
    link, Advantra_plugin.cpp:2426-2481 + tracker.cpp:850-862), and
    multi-tree extraction.

    Returns (volume uint8, gold SWC rows: soma centers + centerlines)."""
    rng = np.random.default_rng(seed)
    soma_a = (24.0, 28.0, 10.0)   # (x, y, z)
    soma_b = (104.0, 68.0, 10.0)
    neurites = [
        # (start soma, end point, radius): start OUTSIDE the soma blob
        (soma_a, (72.0, 28.0, 10.0), 2.2),   # A1: straight +x
        (soma_a, (56.0, 62.0, 10.0), 1.8),   # A2: diagonal, thinner
        (soma_b, (64.0, 82.0, 10.0), 2.2),   # B1: -x toward the edge
        (soma_b, (116.0, 24.0, 10.0), 1.8),  # B2: down-right, thinner
    ]

    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    vol = np.zeros(shape)
    gold = []
    nid = 0
    for sx, sy, sz in (soma_a, soma_b):
        d2 = (x - sx) ** 2 + (y - sy) ** 2 + ((z - sz) * zdist) ** 2
        np.maximum(vol, 1.2 * np.exp(-d2 / (2 * 5.0**2)), out=vol)
        nid += 1
        gold.append([nid, 1, sx, sy, sz, 5.0, -1])
    for (sx, sy, sz), (ex, ey, ez), radius in neurites:
        seg = np.asarray([ex - sx, ey - sy, ez - sz])
        length = np.linalg.norm(seg)
        root = 1 if (sx, sy, sz) == soma_a else 2
        first = True
        # the tube is DRAWN from inside the soma blob (t=5/len) so the
        # image is continuous, but gold points start outside the soma
        # suppression zone (t=10/len): seeds inside the smap are
        # dropped and traces STOP at the soma, so centerline inside it
        # is structurally unreachable (reference semantics)
        for t in np.linspace(5.0 / length, 1.0, int(length)):
            px, py, pz = np.asarray([sx, sy, sz]) + t * seg
            d2 = (x - px) ** 2 + (y - py) ** 2 + ((z - pz) * zdist) ** 2
            np.maximum(vol, np.exp(-d2 / (2 * radius**2)), out=vol)
            if t * length < 10.0:
                continue
            nid += 1
            gold.append([nid, 2, px, py, pz, radius, root if first else nid - 1])
            first = False
    intensity = 185.0 * (0.78 + 0.22 * np.sin(x / 5.0))
    vol = np.clip(vol * intensity + rng.normal(0, 5, shape), 0, 255).astype(np.uint8)
    return vol, np.asarray(gold, np.float64)


def snr_phantom(
    noise_sigma,
    shape=(16, 72, 96),
    radius=2.2,
    zdist=2.0,
    seed=11,
    amplitude=150.0,
    bg_gradient=True,
    psf=True,
):
    """Realism-battery phantom (VERDICT r3 item 6): the Y-neuron under
    microscopy-like degradations — a linear background ramp, an
    anisotropic PSF blur (z wider than xy, like a confocal z-spread),
    and additive Gaussian noise. The reference's intended data is noisy
    anisotropic microscopy (reference README.md:11-13); its stacks are
    not vendored, so this battery records an operating envelope instead.

    SNR := tube amplitude above local background / noise sigma.
    Returns (volume uint8, gold SWC rows, snr)."""
    rng = np.random.default_rng(seed)
    pts = []
    for t in np.linspace(0, 1, 60):
        pts.append((8 + 40 * t, 36.0, 8.0))
    for t in np.linspace(0, 1, 50):
        pts.append((48 + 38 * t, 36 + 20 * t, 8.0))
    for t in np.linspace(0, 1, 50):
        pts.append((48 + 38 * t, 36 - 20 * t, 8.0))
    pts = np.asarray(pts)

    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    tube = np.zeros(shape)
    for px, py, pz in pts:
        d2 = (x - px) ** 2 + (y - py) ** 2 + ((z - pz) * zdist) ** 2
        np.maximum(tube, np.exp(-d2 / (2 * radius**2)), out=tube)
    vol = amplitude * tube
    if bg_gradient:
        # a 20->55 intensity ramp across y: autofluorescence-like
        # structured background the global thresholds must survive
        vol = vol + 20.0 + 35.0 * (y / max(shape[1] - 1, 1))
    if psf:
        import scipy.ndimage as ndi

        # anisotropic PSF: z-spread ~2x the lateral one in physical
        # units (z voxels already cover zdist microns each)
        vol = ndi.gaussian_filter(vol, sigma=(1.6 / zdist * 2.0, 0.8, 0.8))
    vol = np.clip(vol + rng.normal(0, noise_sigma, shape), 0, 255).astype(
        np.uint8
    )

    gold = []
    for i, (px, py, pz) in enumerate(pts, start=1):
        if i == 1:
            parent = -1
        elif i == 111:
            parent = 60
        else:
            parent = i - 1
        gold.append([i, 2, px, py, pz, radius, parent])
    snr = amplitude / max(noise_sigma, 1e-9)
    return vol, np.asarray(gold, np.float64), snr
