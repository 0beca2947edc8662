"""Material pipelines: multi-output graph templates for PBR texture maps.

Port of the templates of `kanter_core_tpu/models/__init__.py`, with the
same defaults and node ids: `ambient_occlusion_graph`, `pbr_material_graph`
and `emboss_graph` take a height input; `wood`, `stone`, `metal`, `brick`
and `cobblestone_material_graph` are fully procedural. They compose the
engine's node vocabulary into material pipelines with multiple named
outputs. All math happens in the graph, so the pipelines inherit
everything the engine gives graphs: incremental dirty re-eval of single
maps, fused evaluation, and recipe-cache hits on parameter undo.
"""


from __future__ import annotations

from ..ids import NodeId, SlotId
from ..node import MixType, Node, NodeType
from ..node_graph import NodeGraph


def _value(graph: NodeGraph, v: float) -> NodeId:
    return graph.add_node(Node(NodeType.Value(v)))


def _mix(graph: NodeGraph, mix_type: MixType, left: NodeId, right: NodeId,
         left_slot: SlotId = SlotId(0), right_slot: SlotId = SlotId(0)) -> NodeId:
    node = graph.add_node(Node(NodeType.Mix(mix_type)))
    graph.connect(left, node, left_slot, SlotId(0))
    graph.connect(right, node, right_slot, SlotId(1))
    return node


def ambient_occlusion_graph(sigma: float = 6.0, strength: float = 0.75) -> NodeGraph:
    """Gray heightmap in → screen-space-style AO approximation out.

    Local concavity: `ao = 1 − strength·(blur_σ(h) − h)` (unclamped in f32;
    ridges where blur(h) < h exceed 1.0 until u8 export clamps) — cavities
    (where the neighborhood average exceeds the height) darken, ridges stay
    white. Mix clamps to [0, 1] exactly like the reference's kernels
    (`mix.rs:136-192` operates on raw f32; the clamp comes from the u8
    export and the SUBTRACT's consumers here keep values in range).
    """
    graph = NodeGraph()
    height = graph.add_node(Node(NodeType.InputGray("height")))
    blur = graph.add_node(Node(NodeType.Blur(sigma)))
    graph.connect(height, blur, SlotId(0), SlotId(0))
    # cavity = blur(h) - h  (negative on ridges; SUBTRACT keeps raw f32)
    cavity = _mix(graph, MixType.SUBTRACT, blur, height)
    # scaled = cavity * strength
    scaled = _mix(graph, MixType.MULTIPLY, cavity, _value(graph, strength))
    # ao = 1 - scaled  (ridges: scaled < 0 → ao > 1, clamped at u8 export,
    # and by the resize clamp if consumed at another size — reference parity)
    ao = _mix(graph, MixType.SUBTRACT, _value(graph, 1.0), scaled,
              right_slot=SlotId(0))
    out = graph.add_node(Node(NodeType.OutputGray("ao")))
    graph.connect(ao, out, SlotId(0), SlotId(0))
    return graph


def pbr_material_graph(
    normal_pre_sigma: float = 0.8,
    ao_sigma: float = 6.0,
    ao_strength: float = 0.75,
    roughness_base: float = 0.35,
    roughness_cavity: float = 0.5,
) -> NodeGraph:
    """Gray heightmap in → four PBR texture maps out, one graph:

    - `normal`  (RGBA): pre-blurred height → tangent-space normal map;
    - `ao`      (gray): cavity AO, `1 − k·(blur(h) − h)` (f32-unclamped);
    - `roughness` (gray): `base + cavity_weight·(1 − ao)` — cavities are
      rougher (dirt/wear accumulates there);
    - `albedo`  (RGBA): height-tinted base color (height-lerped channels).

    The whole material is ONE dirty-tracked graph: editing `ao_sigma`
    re-evaluates only the AO/roughness branch; the engine fuses whatever is
    dirty into a single evaluation per read. Embed it as a `Graph` node to
    stamp materials inside larger compositions.
    """
    graph = NodeGraph()
    height = graph.add_node(Node(NodeType.InputGray("height")))

    # --- normal branch ---
    pre = graph.add_node(Node(NodeType.Blur(normal_pre_sigma)))
    graph.connect(height, pre, SlotId(0), SlotId(0))
    h2n = graph.add_node(Node(NodeType.HeightToNormal()))
    graph.connect(pre, h2n, SlotId(0), SlotId(0))
    normal_out = graph.add_node(Node(NodeType.OutputRgba("normal")))
    graph.connect(h2n, normal_out, SlotId(0), SlotId(0))

    # --- ao branch: 1 - strength * (blur(h) - h) ---
    ao_blur = graph.add_node(Node(NodeType.Blur(ao_sigma)))
    graph.connect(height, ao_blur, SlotId(0), SlotId(0))
    cavity = _mix(graph, MixType.SUBTRACT, ao_blur, height)
    scaled = _mix(graph, MixType.MULTIPLY, cavity, _value(graph, ao_strength))
    ao = _mix(graph, MixType.SUBTRACT, _value(graph, 1.0), scaled)
    ao_out = graph.add_node(Node(NodeType.OutputGray("ao")))
    graph.connect(ao, ao_out, SlotId(0), SlotId(0))

    # --- roughness branch: base + cavity_weight * (1 - ao) = base + cw*scaled
    rough = _mix(
        graph, MixType.ADD,
        _mix(graph, MixType.MULTIPLY, scaled, _value(graph, roughness_cavity)),
        _value(graph, roughness_base),
    )
    rough_out = graph.add_node(Node(NodeType.OutputGray("roughness")))
    graph.connect(rough, rough_out, SlotId(0), SlotId(0))

    # --- albedo branch: per-channel lerp between two tints by height ---
    # channel = low + h * (high - low), expressed with Value nodes so tint
    # edits are argument swaps of the cached evaluator
    low = (0.22, 0.17, 0.12)   # cavity tint
    high = (0.58, 0.52, 0.45)  # ridge tint
    channels = []
    for lo, hi in zip(low, high):
        span = _mix(graph, MixType.MULTIPLY, height, _value(graph, hi - lo))
        channels.append(_mix(graph, MixType.ADD, span, _value(graph, lo)))
    combine = graph.add_node(Node(NodeType.CombineRgba()))
    for i, ch in enumerate(channels):
        graph.connect(ch, combine, SlotId(0), SlotId(i))
    albedo_out = graph.add_node(Node(NodeType.OutputRgba("albedo")))
    graph.connect(combine, albedo_out, SlotId(0), SlotId(0))

    return graph


def wood_material_graph(
    size: int = 512,
    seed: int = 3,
    grain_stretch: float = 6.0,
    wobble: float = 9.0,
    ring_contrast: float = 1.6,
) -> NodeGraph:
    """Fully procedural wood material: NO inputs, four outputs
    (`albedo` RGBA, `height`/`roughness` gray, `normal` RGBA).

    Source-to-surface pipeline built entirely from the extension node
    vocabulary (the reference has no procedural sources at all —
    `vismut_core/src/node/` starts from Image/Value leaves):

    - grain: seamless FBM noise stretched `grain_stretch×` along y by a
      `Transform` (toroidal sampling keeps it tileable), then domain-warped
      sideways by a SECOND low-frequency noise through `Warp` (angle 0 ⇒
      +x displacement) — the classic grain-wobble construction;
    - height: `Levels` ring-contrast remap of the warped grain;
    - albedo: `GradientMap` through four wood-tone stops (earlywood/
      latewood bands);
    - normal: blur → `HeightToNormal` of the height;
    - roughness: inverted-range `Levels` (ridges polish smoother than
      open grain; `out_lo > out_hi` is a legal inverting remap).

    Every scalar above (stretch, wobble, contrast, stops, sigma) rides as
    a evaluator argument — parameter drags re-run the cached evaluator; only
    `size` and the noise octave/stop counts shape the evaluation. Embeds as a
    zero-input `Graph` node. Also the undo/redo showcase: each knob edit
    is one history unit.
    """
    graph = NodeGraph()
    grain = graph.add_node(Node(NodeType.Noise(size, size, 5, 4, seed)))
    stretch = graph.add_node(
        Node(NodeType.Transform(0.0, 0.0, 0.0, 1.0, grain_stretch))
    )
    graph.connect(grain, stretch, SlotId(0), SlotId(0))
    wob_src = graph.add_node(
        Node(NodeType.Noise(size, size, 3, 2, seed + 1))
    )
    warp = graph.add_node(Node(NodeType.Warp(0.0, wobble)))
    graph.connect(stretch, warp, SlotId(0), SlotId(0))
    graph.connect(wob_src, warp, SlotId(0), SlotId(1))

    height = graph.add_node(
        Node(NodeType.Levels(0.2, 0.8, ring_contrast, 0.0, 1.0))
    )
    graph.connect(warp, height, SlotId(0), SlotId(0))
    height_out = graph.add_node(Node(NodeType.OutputGray("height")))
    graph.connect(height, height_out, SlotId(0), SlotId(0))

    albedo = graph.add_node(
        Node(
            NodeType.GradientMap(
                [
                    (0.0, 0.26, 0.15, 0.06, 1.0),   # latewood (dark band)
                    (0.42, 0.45, 0.28, 0.13, 1.0),
                    (0.72, 0.60, 0.42, 0.22, 1.0),  # earlywood
                    (1.0, 0.72, 0.55, 0.34, 1.0),
                ]
            )
        )
    )
    graph.connect(height, albedo, SlotId(0), SlotId(0))
    albedo_out = graph.add_node(Node(NodeType.OutputRgba("albedo")))
    graph.connect(albedo, albedo_out, SlotId(0), SlotId(0))

    pre = graph.add_node(Node(NodeType.Blur(0.8)))
    graph.connect(height, pre, SlotId(0), SlotId(0))
    h2n = graph.add_node(Node(NodeType.HeightToNormal()))
    graph.connect(pre, h2n, SlotId(0), SlotId(0))
    normal_out = graph.add_node(Node(NodeType.OutputRgba("normal")))
    graph.connect(h2n, normal_out, SlotId(0), SlotId(0))

    rough = graph.add_node(Node(NodeType.Levels(0.0, 1.0, 1.0, 0.85, 0.45)))
    graph.connect(height, rough, SlotId(0), SlotId(0))
    rough_out = graph.add_node(Node(NodeType.OutputGray("roughness")))
    graph.connect(rough, rough_out, SlotId(0), SlotId(0))
    return graph


def stone_material_graph(
    size: int = 512,
    seed: int = 11,
    crack_warp: float = 14.0,
    crack_gamma: float = 2.4,
    ao_sigma: float = 5.0,
    vignette: float = 0.0,
) -> NodeGraph:
    """Fully procedural stone/rock material: NO inputs, five outputs
    (`albedo` RGBA, `height`/`roughness`/`ao` gray, `normal` RGBA).

    Self-warped FBM ("domain warping"): a high-octave noise is displaced
    by ITS OWN low-frequency field through `Warp`, which folds smooth
    blobs into crack-like creases; a high-gamma `Levels` deepens the
    creases into fissures. Albedo is a cool gray-stone `GradientMap`, AO
    is the multi-scale `AmbientOcclusion` node (octave sigmas at
    `ao_sigma`·(1,2,4)/4), and roughness ADDs the occlusion (1 − ao) on
    top of a base via Mix (cavities are rougher). All scalars except the
    AO radius are evaluator arguments; `size`/octaves/stop count/AO taps
    shape the evaluation.
    """
    graph = NodeGraph()
    base = graph.add_node(Node(NodeType.Noise(size, size, 6, 5, seed)))
    field = graph.add_node(Node(NodeType.Noise(size, size, 3, 2, seed)))
    warp = graph.add_node(Node(NodeType.Warp(47.0, crack_warp)))
    graph.connect(base, warp, SlotId(0), SlotId(0))
    graph.connect(field, warp, SlotId(0), SlotId(1))

    height = graph.add_node(
        Node(NodeType.Levels(0.15, 0.9, crack_gamma, 0.0, 1.0))
    )
    graph.connect(warp, height, SlotId(0), SlotId(0))
    height_out = graph.add_node(Node(NodeType.OutputGray("height")))
    graph.connect(height, height_out, SlotId(0), SlotId(0))

    albedo = graph.add_node(
        Node(
            NodeType.GradientMap(
                [
                    (0.0, 0.13, 0.13, 0.15, 1.0),   # fissure shadow
                    (0.35, 0.38, 0.38, 0.40, 1.0),
                    (0.7, 0.55, 0.54, 0.52, 1.0),
                    (1.0, 0.72, 0.70, 0.66, 1.0),   # weathered face
                ]
            )
        )
    )
    graph.connect(height, albedo, SlotId(0), SlotId(0))
    albedo_out = graph.add_node(Node(NodeType.OutputRgba("albedo")))
    if vignette > 0.0:
        # radial Ramp vignette (the 26th node's gradient source): corners
        # darken by up to `vignette` of full scale — LEFT stays the RGBA
        # albedo so the Mix keeps the color type
        rmp = graph.add_node(Node(NodeType.Ramp(
            size, size, "Radial", 0.0, 0.5, 0.5, float(vignette),
        )))
        shade = _mix(graph, MixType.SUBTRACT, _value(graph, 1.0), rmp)
        albedo = _mix(graph, MixType.MULTIPLY, albedo, shade)
    graph.connect(albedo, albedo_out, SlotId(0), SlotId(0))

    pre = graph.add_node(Node(NodeType.Blur(1.0)))
    graph.connect(height, pre, SlotId(0), SlotId(0))
    h2n = graph.add_node(Node(NodeType.HeightToNormal()))
    graph.connect(pre, h2n, SlotId(0), SlotId(0))
    normal_out = graph.add_node(Node(NodeType.OutputRgba("normal")))
    graph.connect(h2n, normal_out, SlotId(0), SlotId(0))

    # multi-scale AO node (sigmas radius·(1,2,4); radius = ao_sigma/4 puts
    # the largest scale at the template's historical single-scale sigma);
    # roughness = 0.55 + 0.5*(1 - ao) — cavities are rougher
    ao = graph.add_node(
        Node(NodeType.AmbientOcclusion(2.4, ao_sigma / 4.0))
    )
    graph.connect(height, ao, SlotId(0), SlotId(0))
    ao_out = graph.add_node(Node(NodeType.OutputGray("ao")))
    graph.connect(ao, ao_out, SlotId(0), SlotId(0))
    occ = _mix(graph, MixType.SUBTRACT, _value(graph, 1.0), ao)
    rough = _mix(
        graph, MixType.ADD,
        _mix(graph, MixType.MULTIPLY, occ, _value(graph, 0.5)),
        _value(graph, 0.55),
    )
    rough_out = graph.add_node(Node(NodeType.OutputGray("roughness")))
    graph.connect(rough, rough_out, SlotId(0), SlotId(0))
    return graph


def metal_material_graph(
    size: int = 512,
    seed: int = 7,
    brush_stretch: float = 24.0,
    brush_amp: float = 0.12,
    scratch_gamma: float = 3.2,
    scratch_depth: float = 0.3,
    metallic: float = 0.92,
) -> NodeGraph:
    """Fully procedural brushed-metal material: NO inputs, five outputs
    (`albedo`/`normal` RGBA, `height`/`roughness`/`metallic` gray).

    The brushed-surface construction (vocabulary as wood/stone,
    `vismut_core/src/node/` has no procedural sources):

    - brushing: fine FBM noise stretched `brush_stretch×` along x by a
      `Transform` — long anisotropic streaks (toroidal sampling keeps the
      sheet tileable);
    - scratches: a second, coarser noise through a high-gamma `Levels`
      crush — sparse bright marks on a near-black field;
    - height: near-flat plate, `0.55 + brush_amp·(streaks − ½)
      − scratch_depth·scratches`, built from Mix ADD/SUBTRACT/MULTIPLY;
    - albedo: cool steel `GradientMap` of the height;
    - roughness: polished base + scratch-driven wear
      (`0.15 + 0.6·scratches`);
    - metallic: constant-`metallic` plane AT CANVAS SIZE via the
      degenerate `Levels` remap `out_lo == out_hi` (a Value node would be
      1×1 — the remap stamps the constant at the height's resolution);
    - normal: blur → `HeightToNormal` of the height.

    Every scalar rides as a evaluator argument (knob drags re-run the cached
    evaluator); `size`/octaves/stop counts shape the evaluation.
    """
    graph = NodeGraph()
    streaks_src = graph.add_node(Node(NodeType.Noise(size, size, 6, 5, seed)))
    streaks = graph.add_node(
        Node(NodeType.Transform(0.0, 0.0, 0.0, brush_stretch, 1.0))
    )
    graph.connect(streaks_src, streaks, SlotId(0), SlotId(0))

    scratch_src = graph.add_node(Node(NodeType.Noise(size, size, 9, 3, seed + 1)))
    scratches = graph.add_node(
        Node(NodeType.Levels(0.55, 0.95, scratch_gamma, 0.0, 1.0))
    )
    graph.connect(scratch_src, scratches, SlotId(0), SlotId(0))

    # height = (0.55 + brush_amp*(streaks - 0.5)) - scratch_depth*scratches
    brush_centered = _mix(graph, MixType.SUBTRACT, streaks, _value(graph, 0.5))
    brush_fine = _mix(
        graph, MixType.MULTIPLY, brush_centered, _value(graph, brush_amp)
    )
    plate = _mix(graph, MixType.ADD, brush_fine, _value(graph, 0.55))
    scratch_term = _mix(
        graph, MixType.MULTIPLY, scratches, _value(graph, scratch_depth)
    )
    height = _mix(graph, MixType.SUBTRACT, plate, scratch_term)
    height_out = graph.add_node(Node(NodeType.OutputGray("height")))
    graph.connect(height, height_out, SlotId(0), SlotId(0))

    albedo = graph.add_node(
        Node(
            NodeType.GradientMap(
                [
                    (0.0, 0.18, 0.19, 0.22, 1.0),   # scratch shadow
                    (0.45, 0.46, 0.48, 0.52, 1.0),
                    (0.62, 0.62, 0.64, 0.68, 1.0),  # plate body
                    (1.0, 0.82, 0.84, 0.88, 1.0),   # specular-ish sheen
                ]
            )
        )
    )
    graph.connect(height, albedo, SlotId(0), SlotId(0))
    albedo_out = graph.add_node(Node(NodeType.OutputRgba("albedo")))
    graph.connect(albedo, albedo_out, SlotId(0), SlotId(0))

    rough = _mix(
        graph, MixType.ADD,
        _mix(graph, MixType.MULTIPLY, scratches, _value(graph, 0.6)),
        _value(graph, 0.15),
    )
    rough_out = graph.add_node(Node(NodeType.OutputGray("roughness")))
    graph.connect(rough, rough_out, SlotId(0), SlotId(0))

    metal = graph.add_node(Node(NodeType.Levels(0.0, 1.0, 1.0, metallic, metallic)))
    graph.connect(height, metal, SlotId(0), SlotId(0))
    metal_out = graph.add_node(Node(NodeType.OutputGray("metallic")))
    graph.connect(metal, metal_out, SlotId(0), SlotId(0))

    pre = graph.add_node(Node(NodeType.Blur(0.6)))
    graph.connect(height, pre, SlotId(0), SlotId(0))
    h2n = graph.add_node(Node(NodeType.HeightToNormal()))
    graph.connect(pre, h2n, SlotId(0), SlotId(0))
    normal_out = graph.add_node(Node(NodeType.OutputRgba("normal")))
    graph.connect(h2n, normal_out, SlotId(0), SlotId(0))
    return graph


def brick_material_graph(
    size: int = 512,
    seed: int = 5,
    bricks_x: int = 6,
    bricks_y: int = 12,
    mortar: float = 0.12,
    bevel: float = 0.05,
    brick_relief: float = 0.55,
    tint_spread: float = 0.5,
    wear: float = 1.0,
    damp: float = 0.30,
    damp_spread: float | None = None,
) -> NodeGraph:
    """Fully procedural brick-wall material: NO inputs, five outputs
    (`albedo`/`normal` RGBA, `height`/`roughness`/`ao` gray).

    The `Pattern` node's showcase (vocabulary as wood/stone/metal —
    `vismut_core/src/node/` has no procedural sources): its Brick
    lattice emits BOTH outputs at once — `mask` (slot 0, the beveled
    running-bond groove field) and `cells` (slot 1, a per-brick random ID)
    — and every consumer below uses each exactly once:

    - height: `0.2 + relief·mask + 0.1·cells·mask + 0.05·(noise − ½)` —
      mortar recessed, bricks raised with per-brick height jitter and a
      fine FBM surface grain;
    - field → albedo: one gray scalar `mask·(0.35 + spread·cells)
      + 0.15·(1 − mask)` collapses "which material, which brick" into a
      GradientMap coordinate: mortar lands on the gray stop at 0.15,
      bricks spread across the red-tone ramp above 0.35 (per-brick tint
      variation from ONE ramp — no per-channel plumbing);
    - roughness: `0.95 − 0.45·mask + 0.2·cells·mask` — mortar roughest,
      bricks vary per brick;
    - ao: the shared `1 − k·(blur(h) − h)` cavity construction (grooves
      self-shadow);
    - normal: blur → `HeightToNormal` of the height (the bevel ramp
      becomes the brick edge chamfer);
    - edge wear: the pre-grain height's own convexity (`Curvature` — the
      bevel shoulders light up) through a Levels gate makes a wear mask
      that polishes roughness down (`−0.35·wear`) and lightens the albedo
      coordinate (`+0.25·wear`) exactly at brick edges — the canonical
      curvature-map workflow, in-graph;
    - damp apron: the `Distance` node's showcase — mortar moisture creeps
      into the bricks. Seeds are the mortar field (`1 − mask > 0.5`), the
      jump-flooded fade `apron` is masked to brick faces and MULTIPLIES
      the final albedo by `1 − damp·apron·mask` (post-GradientMap, so it
      can only darken — the brick gradient is not luminance-monotone, a
      coordinate shift could brighten; Mix re-forces alpha to 1): a damp
      ring hugging every mortar line, spread `damp_spread` px (default
      `max(4, size/24)` — a drag-able evaluator argument, like every other
      knob).

    Every scalar (mortar, bevel, relief, spread, cell counts, seed) rides
    as a evaluator argument — knob drags re-run the cached evaluator; only
    `size` and the Brick kind shape the evaluation.
    """
    graph = NodeGraph()
    pat = graph.add_node(Node(NodeType.Pattern(
        size, size, "Brick", cells_x=bricks_x, cells_y=bricks_y,
        mortar=mortar, bevel=bevel, seed=seed,
    )))
    MASK, CELLS = SlotId(0), SlotId(1)

    # height = 0.2 + relief*mask + 0.1*cells*mask + 0.05*(noise - 0.5)
    raised = _mix(graph, MixType.MULTIPLY, pat, _value(graph, brick_relief),
                  left_slot=MASK)
    jitter_field = _mix(graph, MixType.MULTIPLY, pat, pat,
                        left_slot=CELLS, right_slot=MASK)
    jitter = _mix(graph, MixType.MULTIPLY, jitter_field, _value(graph, 0.1))
    grain_src = graph.add_node(Node(NodeType.Noise(size, size, 7, 3, seed + 1)))
    grain_centered = _mix(graph, MixType.SUBTRACT, grain_src, _value(graph, 0.5))
    grain = _mix(graph, MixType.MULTIPLY, grain_centered, _value(graph, 0.05))
    plateau = _mix(graph, MixType.ADD, raised, _value(graph, 0.2))
    bumpy = _mix(graph, MixType.ADD, plateau, jitter)
    height = _mix(graph, MixType.ADD, bumpy, grain)
    height_out = graph.add_node(Node(NodeType.OutputGray("height")))
    graph.connect(height, height_out, SlotId(0), SlotId(0))

    # edge-wear mask: curvature of the PRE-grain height (so wear follows
    # brick edges, not noise speckle), gated to the convex shoulder band
    curv = graph.add_node(Node(NodeType.Curvature(12.0)))
    graph.connect(bumpy, curv, SlotId(0), SlotId(0))
    wear_gate = graph.add_node(Node(NodeType.Levels(0.55, 0.80, 1.0, 0.0, 1.0)))
    graph.connect(curv, wear_gate, SlotId(0), SlotId(0))
    wear_mask = _mix(graph, MixType.MULTIPLY, wear_gate, _value(graph, wear))

    # albedo coordinate: mask*(0.35 + spread*cells) + 0.15*(1 - mask)
    #                    + 0.25*wear (worn edges climb toward lighter stops)
    brick_val = _mix(
        graph, MixType.ADD,
        _mix(graph, MixType.MULTIPLY, pat, _value(graph, tint_spread),
             left_slot=CELLS),
        _value(graph, 0.35),
    )
    brick_part = _mix(graph, MixType.MULTIPLY, brick_val, pat,
                      right_slot=MASK)
    inv_mask = _mix(graph, MixType.SUBTRACT, _value(graph, 1.0), pat,
                    right_slot=MASK)
    mortar_part = _mix(graph, MixType.MULTIPLY, inv_mask, _value(graph, 0.15))
    field = _mix(graph, MixType.ADD, brick_part, mortar_part)
    field = _mix(
        graph, MixType.ADD, field,
        _mix(graph, MixType.MULTIPLY, wear_mask, _value(graph, 0.25)),
    )
    # damp apron (Distance showcase): mortar seeds → jump-flooded fade →
    # masked to brick faces → multiplicative darkening factor for albedo
    if damp_spread is None:
        damp_spread = max(4.0, size / 24.0)
    apron = graph.add_node(Node(NodeType.Distance(damp_spread)))
    graph.connect(inv_mask, apron, SlotId(0), SlotId(0))
    damp_ring = _mix(graph, MixType.MULTIPLY, apron, pat, right_slot=MASK)
    damp_factor = _mix(
        graph, MixType.SUBTRACT, _value(graph, 1.0),
        _mix(graph, MixType.MULTIPLY, damp_ring, _value(graph, damp)),
    )
    albedo = graph.add_node(
        Node(
            NodeType.GradientMap(
                [
                    (0.0, 0.10, 0.08, 0.08, 1.0),   # groove shadow
                    (0.15, 0.58, 0.56, 0.54, 1.0),  # mortar gray
                    (0.35, 0.48, 0.20, 0.14, 1.0),  # dark brick
                    (0.70, 0.70, 0.33, 0.22, 1.0),  # mid brick
                    (1.0, 0.82, 0.48, 0.34, 1.0),   # light brick
                ]
            )
        )
    )
    graph.connect(field, albedo, SlotId(0), SlotId(0))
    # rgba LEFT so the gray factor coerces rgba-wards; alpha re-forced to 1
    damp_albedo = _mix(graph, MixType.MULTIPLY, albedo, damp_factor)
    albedo_out = graph.add_node(Node(NodeType.OutputRgba("albedo")))
    graph.connect(damp_albedo, albedo_out, SlotId(0), SlotId(0))

    # roughness = 0.95 - 0.45*mask + 0.2*cells*mask - 0.35*wear
    # (worn edges polish smooth)
    rough = _mix(
        graph, MixType.ADD,
        _mix(
            graph, MixType.SUBTRACT, _value(graph, 0.95),
            _mix(graph, MixType.MULTIPLY, pat, _value(graph, 0.45),
                 left_slot=MASK),
        ),
        _mix(graph, MixType.MULTIPLY, jitter_field, _value(graph, 0.2)),
    )
    rough = _mix(
        graph, MixType.SUBTRACT, rough,
        _mix(graph, MixType.MULTIPLY, wear_mask, _value(graph, 0.35)),
    )
    rough_out = graph.add_node(Node(NodeType.OutputGray("roughness")))
    graph.connect(rough, rough_out, SlotId(0), SlotId(0))

    # ao = 1 - 0.8*(blur(h) - h): grooves self-shadow
    ao_blur = graph.add_node(Node(NodeType.Blur(3.0)))
    graph.connect(height, ao_blur, SlotId(0), SlotId(0))
    cavity = _mix(graph, MixType.SUBTRACT, ao_blur, height)
    scaled = _mix(graph, MixType.MULTIPLY, cavity, _value(graph, 0.8))
    ao = _mix(graph, MixType.SUBTRACT, _value(graph, 1.0), scaled)
    ao_out = graph.add_node(Node(NodeType.OutputGray("ao")))
    graph.connect(ao, ao_out, SlotId(0), SlotId(0))

    pre = graph.add_node(Node(NodeType.Blur(0.7)))
    graph.connect(height, pre, SlotId(0), SlotId(0))
    h2n = graph.add_node(Node(NodeType.HeightToNormal()))
    graph.connect(pre, h2n, SlotId(0), SlotId(0))
    normal_out = graph.add_node(Node(NodeType.OutputRgba("normal")))
    graph.connect(h2n, normal_out, SlotId(0), SlotId(0))
    return graph


def cobblestone_material_graph(
    size: int = 512,
    seed: int = 23,
    cells: int = 6,
    jitter: float = 0.9,
    gap: float = 0.22,
    relief: float = 0.6,
    tint_spread: float = 0.5,
    ao_sigma: float = 5.0,
) -> NodeGraph:
    """Fully procedural cobblestone material: NO inputs, five outputs
    (`albedo`/`normal` RGBA, `height`/`roughness`/`ao` gray).

    The `Voronoi` node's showcase — all THREE outputs of one cellular
    source drive the whole material:

    - `distance` (F1): inverted into per-stone domes (`1 − F1` peaks at
      each stone's center and falls toward its edges);
    - `borders` (F2−F1): a `Levels` ramp over [0, `gap`] carves the
      mortar channels (the field is exactly 0 on the cell walls), giving
      a groove mask that is 0 in the joints and 1 on stone tops;
    - `cells` (per-stone ID): per-stone tint/roughness variation through
      ONE GradientMap coordinate, exactly like brick's `cells` slot.

    height = `0.15 + relief·dome·groove + 0.04·(noise − ½)` — joints
    recessed, domed stones with fine FBM grain; albedo collapses
    "joint vs which-stone" into one ramp coordinate
    (`groove·(0.35 + spread·id) + 0.14·(1 − groove)`); roughness =
    `0.9 − 0.45·groove + 0.2·id·groove` (joints roughest, stones vary);
    ao/normal reuse the shared constructions (multi-scale
    `AmbientOcclusion`, blur → `HeightToNormal`). All scalars ride as
    evaluator arguments; `size`/stop count/AO taps shape the evaluation."""
    graph = NodeGraph()
    vor = graph.add_node(Node(NodeType.Voronoi(
        size, size, cells, cells, jitter, seed,
    )))
    grain = graph.add_node(Node(NodeType.Noise(size, size, 8, 3, seed + 1)))

    # groove mask: 0 in the joints (borders ≈ 0 on walls), 1 on stone tops
    groove = graph.add_node(Node(NodeType.Levels(0.0, gap, 1.0, 0.0, 1.0)))
    graph.connect(vor, groove, SlotId(1), SlotId(0))
    # per-stone dome: 1 − F1
    dome = _mix(graph, MixType.SUBTRACT, _value(graph, 1.0), vor)

    # height = 0.15 + relief·dome·groove + 0.04·(grain − 0.5)
    stones = _mix(graph, MixType.MULTIPLY, dome, groove)
    raised = _mix(graph, MixType.MULTIPLY, stones, _value(graph, relief))
    detail = _mix(
        graph, MixType.MULTIPLY,
        _mix(graph, MixType.SUBTRACT, grain, _value(graph, 0.5)),
        _value(graph, 0.04),
    )
    height = _mix(
        graph, MixType.ADD,
        _mix(graph, MixType.ADD, raised, detail),
        _value(graph, 0.15),
    )
    height_out = graph.add_node(Node(NodeType.OutputGray("height")))
    graph.connect(height, height_out, SlotId(0), SlotId(0))

    # albedo coordinate: groove·(0.35 + spread·id) + 0.14·(1 − groove)
    tinted = _mix(
        graph, MixType.ADD,
        _mix(
            graph, MixType.MULTIPLY,
            _mix(graph, MixType.MULTIPLY, _value(graph, tint_spread), vor,
                 right_slot=SlotId(2)),  # the per-stone ID slot
            groove,
        ),
        _mix(graph, MixType.MULTIPLY, groove, _value(graph, 0.35)),
    )
    joint = _mix(
        graph, MixType.MULTIPLY,
        _mix(graph, MixType.SUBTRACT, _value(graph, 1.0), groove),
        _value(graph, 0.14),
    )
    coord = _mix(graph, MixType.ADD, tinted, joint)
    albedo = graph.add_node(
        Node(
            NodeType.GradientMap(
                [
                    (0.0, 0.10, 0.10, 0.11, 1.0),   # wet joint shadow
                    (0.30, 0.34, 0.33, 0.32, 1.0),
                    (0.55, 0.48, 0.46, 0.43, 1.0),
                    (0.8, 0.62, 0.60, 0.56, 1.0),
                    (1.0, 0.75, 0.73, 0.68, 1.0),   # sun-bleached stone
                ]
            )
        )
    )
    graph.connect(coord, albedo, SlotId(0), SlotId(0))
    albedo_out = graph.add_node(Node(NodeType.OutputRgba("albedo")))
    graph.connect(albedo, albedo_out, SlotId(0), SlotId(0))

    # roughness = 0.9 − 0.45·groove + 0.2·id·groove
    idvar = _mix(
        graph, MixType.MULTIPLY,
        _mix(graph, MixType.MULTIPLY, vor, groove, left_slot=SlotId(2)),
        _value(graph, 0.2),
    )
    smoothing = _mix(graph, MixType.MULTIPLY, groove, _value(graph, 0.45))
    rough = _mix(
        graph, MixType.ADD,
        _mix(graph, MixType.SUBTRACT, _value(graph, 0.9), smoothing),
        idvar,
    )
    rough_out = graph.add_node(Node(NodeType.OutputGray("roughness")))
    graph.connect(rough, rough_out, SlotId(0), SlotId(0))

    ao = graph.add_node(Node(NodeType.AmbientOcclusion(2.4, ao_sigma / 4.0)))
    graph.connect(height, ao, SlotId(0), SlotId(0))
    ao_out = graph.add_node(Node(NodeType.OutputGray("ao")))
    graph.connect(ao, ao_out, SlotId(0), SlotId(0))

    pre = graph.add_node(Node(NodeType.Blur(1.0)))
    graph.connect(height, pre, SlotId(0), SlotId(0))
    h2n = graph.add_node(Node(NodeType.HeightToNormal()))
    graph.connect(pre, h2n, SlotId(0), SlotId(0))
    normal_out = graph.add_node(Node(NodeType.OutputRgba("normal")))
    graph.connect(h2n, normal_out, SlotId(0), SlotId(0))
    return graph


def emboss_graph(strength: float = 0.6) -> NodeGraph:
    """Gray in → emboss-style relief: `0.5 + k·(h − blur₁(h))` sharpens
    local detail around mid-gray (an unsharp mask re-centered at 0.5)."""
    graph = NodeGraph()
    height = graph.add_node(Node(NodeType.InputGray("height")))
    blur = graph.add_node(Node(NodeType.Blur(1.0)))
    graph.connect(height, blur, SlotId(0), SlotId(0))
    detail = _mix(graph, MixType.SUBTRACT, height, blur)
    scaled = _mix(graph, MixType.MULTIPLY, detail, _value(graph, strength))
    emboss = _mix(graph, MixType.ADD, scaled, _value(graph, 0.5))
    out = graph.add_node(Node(NodeType.OutputGray("emboss")))
    graph.connect(emboss, out, SlotId(0), SlotId(0))
    return graph
