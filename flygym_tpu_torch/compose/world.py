"""Worlds: environments that flies attach to.

Port of ``flygym_tpu/compose/world.py``. :meth:`BaseWorld.compile` adds to
the spec's compile what the JAX package's ``Simulation`` derives from the
world: each fly's index maps (``flygym_tpu/simulation.py:88-150``, in the
form ``scripts/export_torch_model.py:_fly_maps`` writes them) as
``compiled.flies``, and the renderer's cameras and names as
``compiled.render``.

Parity reference: flygym ``compose/world.py`` (BaseWorld :22-207,
FlatGroundWorld :210-331, TetheredWorld :334-366).

Difference from the reference: ``TetheredWorld`` rigidly fixes the fly root at the
spawn pose instead of adding a free joint + a very stiff soft weld
(``world.py:358-365``) — the hard weld removes 6 DoFs and the stiffest
constraint in the model while being behaviorally equivalent at the reference's
solref of 2e-4 s.
"""

from collections import defaultdict
from dataclasses import replace
from typing import Any

from flygym_tpu_torch.anatomy import LEG_LINKS, BodySegment, ContactBodiesPreset
from flygym_tpu_torch.compose.base import BaseCompositionElement
from flygym_tpu_torch.compose.fly import ActuatorType, Fly
from flygym_tpu_torch.compose.physics import ContactParams
from flygym_tpu_torch.compose.spec import (
    ContactSensorSpec,
    GeomSpec,
    ModelSpec,
    PairSpec,
)
from flygym_tpu_torch.utils.math import Rotation3D, Vec3

__all__ = [
    "BaseWorld",
    "FlatGroundWorld",
    "HeightfieldTerrainWorld",
    "BlocksTerrainWorld",
    "GappedTerrainWorld",
    "TetheredWorld",
]


class BaseWorld(BaseCompositionElement):
    """Base class for worlds. A world owns environmental features (ground) and
    defines how flies attach (free-floating, tethered). Multiple flies may be
    added and can interact with the same ground.

    Attributes:
        fly_lookup: Maps fly names to their :class:`Fly` objects.
        world_dof_neutral_states: Neutral values of world-managed DoFs (e.g.
            fly spawn free joints), keyed by joint full identifier.
    """

    def __init__(self, name: str) -> None:
        self._spec = ModelSpec(name)
        self._fly_lookup: dict[str, Fly] = {}
        self.world_dof_neutral_states: dict[str, list[float]] = {}
        self.legpos_to_groundcontactsensors_by_fly = None

    @property
    def spec(self) -> ModelSpec:
        return self._spec

    @property
    def name(self) -> str:
        return self._spec.name

    @property
    def fly_lookup(self) -> dict[str, Fly]:
        """Lookup for :class:`Fly` objects in the world, keyed by fly name."""
        return self._fly_lookup

    def compile_arrays(self) -> tuple:
        """The spec's compile as numpy (:meth:`ModelSpec.compile_arrays`)
        with ``meta["flies"]`` (each fly's index maps) and ``meta["render"]``
        (the cameras, geom names and body name map): what
        ``scripts/export_torch_model.py:export(..., render=True)`` writes.

        Returns:
            (arrays, meta, names).
        """
        arrays, meta, names = self._spec.compile_arrays()
        meta["flies"] = {
            name: _fly_maps(self, names, name, fly)
            for name, fly in self._fly_lookup.items()
        }
        meta["render"] = _render_meta(self._spec, names, meta["model"]["ngeom"])
        return arrays, meta, names

    def compile(self):
        """Compile to ``(PhysicsModel, State)`` on the CPU, as the JAX
        package does; the port's
        :class:`~flygym_tpu_torch.compose.bridge.CompiledModel` (with
        ``flies``, ``render`` and the name maps) is cached on
        ``self.compiled``."""
        from flygym_tpu_torch.compose.bridge import model_from_numpy

        arrays, meta, names = self.compile_arrays()
        self.compiled = replace(model_from_numpy(arrays, meta), names=names)
        return self.compiled.model, self.compiled.initial_state

    def _attach_fly(
        self,
        fly: Fly,
        spawn_position: Vec3,
        spawn_rotation: Rotation3D,
        *args,
        **kwargs,
    ):
        """Attach the fly's spec to the world spec. Implemented by concrete
        worlds; must return the created free JointSpec (or None if the fly is
        rigidly attached)."""
        raise NotImplementedError

    def add_object(
        self,
        name: str,
        pos: Vec3,
        *,
        radius: float = 2.0,
        rgba: tuple = (0.05, 0.05, 0.05, 1.0),
    ) -> GeomSpec:
        """Add a static visual object (sphere) to the world.

        Visible to cameras and the ommatidia retina (visual-taxis targets);
        not collidable (like the reference, collisions are explicit pairs
        only).
        """
        geom = GeomSpec(
            name=name, type="sphere", size=(radius,), pos=tuple(pos), rgba=rgba
        )
        self._spec.world_geoms.append(geom)
        return geom

    def add_fly_fly_contacts(
        self,
        fly1: "Fly | str",
        fly2: "Fly | str",
        *,
        bodysegs: (
            "list[BodySegment] | ContactBodiesPreset | str"
        ) = ContactBodiesPreset.LEGS_THORAX_ABDOMEN_HEAD,
        contact_params: ContactParams = ContactParams(),
    ) -> int:
        """Make two flies in this world physically collide.

        Adds explicit capsule-capsule contact pairs between the selected
        body segments of both flies (the analog of the reference's
        explicit-pair contact machinery for multi-fly worlds,
        ``world.py:95-149``; MuJoCo there falls back to its capsule-capsule
        collider). Both flies must already be attached.

        Args:
            fly1, fly2: Fly objects or names.
            bodysegs: Which segments of EACH fly participate.
            contact_params: Contact model parameters for the pairs.

        Returns:
            The number of contact pairs added.
        """
        name1 = fly1 if isinstance(fly1, str) else fly1.name
        name2 = fly2 if isinstance(fly2, str) else fly2.name
        if name1 == name2:
            raise ValueError("Need two distinct flies for fly-fly contacts.")
        for nm in (name1, name2):
            if nm not in self._fly_lookup:
                raise ValueError(f"Fly '{nm}' is not attached to this world.")
        f1, f2 = self._fly_lookup[name1], self._fly_lookup[name2]
        if isinstance(bodysegs, (ContactBodiesPreset, str)):
            bodysegs = ContactBodiesPreset(bodysegs).to_body_segments_list()
        friction = contact_params.get_friction_tuple()
        solref = contact_params.get_solref_tuple()
        solimp = contact_params.get_solimp_full_tuple()
        n_added = 0
        for s1 in bodysegs:
            g1 = f1.bodyseg_to_specgeom[s1]
            for s2 in bodysegs:
                g2 = f2.bodyseg_to_specgeom[s2]
                self._spec.pairs.append(
                    PairSpec(
                        geom1=g1.full_identifier,
                        geom2=g2.full_identifier,
                        name=f"{name1}.{s1.name}-{name2}.{s2.name}",
                        condim=contact_params.condim,
                        friction=friction,
                        solref=solref,
                        solimp=solimp,
                        margin=contact_params.margin,
                    )
                )
                n_added += 1
        return n_added

    def add_all_fly_fly_contacts(
        self,
        *,
        bodysegs: (
            "list[BodySegment] | ContactBodiesPreset | str"
        ) = ContactBodiesPreset.LEGS_THORAX_ABDOMEN_HEAD,
        contact_params: ContactParams = ContactParams(),
    ) -> int:
        """Make EVERY pair of attached flies physically collide.

        Calls :meth:`add_fly_fly_contacts` for each unordered pair of
        attached flies, in attach order — the N-fly analog of the
        reference's unbounded multi-fly contact support (``add_fly``
        accepts arbitrary fly counts, reference ``world.py:95-149``).
        Each call contributes its own compressed pair groups (one winner
        contact per geom1 per opposing fly when ``pair_compress`` is on).

        Returns:
            The total number of contact pairs added across all fly pairs.
        """
        names = list(self._fly_lookup)
        n_added = 0
        for i, n1 in enumerate(names):
            for n2 in names[i + 1 :]:
                n_added += self.add_fly_fly_contacts(
                    n1, n2, bodysegs=bodysegs, contact_params=contact_params
                )
        return n_added

    def add_fly(
        self,
        fly: Fly,
        spawn_position: Vec3,
        spawn_rotation: Rotation3D,
        *args: Any,
        **kwargs: Any,
    ) -> None:
        """Attach a fly to the world at the given pose (``world.py:95-149``).

        Args:
            fly: The fly to add.
            spawn_position: Initial (x, y, z) position in mm.
            spawn_rotation: Initial orientation (quaternion format required).
            *args, **kwargs: Forwarded to the world-specific attach.
        """
        if fly.name in self._fly_lookup:
            raise ValueError(
                f"Fly with name '{fly.name}' already exists in the world."
            )
        if spawn_rotation.format != "quat":
            raise ValueError(
                "Freejoint neutral rotation can only be specified in quaternion "
                f"format for now. Got {spawn_rotation}."
            )
        self._fly_lookup[fly.name] = fly

        freejoint = self._attach_fly(
            fly, spawn_position, spawn_rotation, *args, **kwargs
        )
        if freejoint is not None:
            self.world_dof_neutral_states[freejoint.full_identifier] = [
                *spawn_position,
                *spawn_rotation.values,
            ]


class FlatGroundWorld(BaseWorld):
    """World with a flat infinite ground plane; flies move freely.

    ``add_fly`` accepts the extra keyword arguments of the reference
    (``world.py:213-221``): ``bodysegs_with_ground_contact``,
    ``ground_contact_params``, ``add_ground_contact_sensors``.

    Args:
        name: Name of the world.
        half_size: Half-size of the ground plane in mm.
    """

    def __init__(
        self, name: str = "flat_ground_world", *, half_size: float = 1000
    ) -> None:
        super().__init__(name=name)
        self.ground_geom = GeomSpec(
            name="ground_plane",
            type="plane",
            size=(half_size, half_size, 1.0),
            rgba=(0.35, 0.35, 0.35, 1.0),
            material="grid",
        )
        self._spec.world_geoms.append(self.ground_geom)
        self.legpos_to_groundcontactsensors_by_fly = None

    def _attach_fly(
        self,
        fly: Fly,
        spawn_position: Vec3,
        spawn_rotation: Rotation3D,
        *,
        bodysegs_with_ground_contact: (
            "list[BodySegment] | ContactBodiesPreset | str"
        ) = ContactBodiesPreset.LEGS_THORAX_ABDOMEN_HEAD,
        ground_contact_params: ContactParams = ContactParams(),
        add_ground_contact_sensors: bool = True,
    ):
        freejoint = self._spec.attach(
            fly.spec,
            prefix=fly.name,
            spawn_pos=tuple(spawn_position),
            spawn_quat=tuple(spawn_rotation.values),
            free_joint_name=fly.name,
        )

        if isinstance(bodysegs_with_ground_contact, (ContactBodiesPreset, str)):
            preset = ContactBodiesPreset(bodysegs_with_ground_contact)
            bodysegs_with_ground_contact = preset.to_body_segments_list()

        self._set_ground_contact(
            fly, bodysegs_with_ground_contact, ground_contact_params
        )
        if add_ground_contact_sensors:
            self._add_ground_contact_sensors(fly, bodysegs_with_ground_contact)
        return freejoint

    def _set_ground_contact(
        self,
        fly: Fly,
        bodysegs_with_ground_contact: list[BodySegment],
        params: ContactParams,
    ) -> None:
        """Explicit per-segment contact pairs vs the ground
        (``world.py:292-309``)."""
        friction = params.get_friction_tuple()
        solref = params.get_solref_tuple()
        solimp = params.get_solimp_full_tuple()
        for segment in bodysegs_with_ground_contact:
            geom = fly.bodyseg_to_specgeom[segment]
            self._spec.pairs.append(
                PairSpec(
                    geom1=geom.full_identifier,
                    geom2=self.ground_geom.full_identifier,
                    name=f"{segment.name}-ground",
                    condim=params.condim,
                    friction=friction,
                    solref=solref,
                    solimp=solimp,
                    margin=params.margin,
                )
            )

    def _add_ground_contact_sensors(
        self, fly: Fly, bodysegs_with_ground_contact: list[BodySegment]
    ) -> None:
        """Per-leg netforce contact sensors rooted at the proximal-most
        contact segment of each leg (``world.py:311-331``)."""
        if self.legpos_to_groundcontactsensors_by_fly is None:
            self.legpos_to_groundcontactsensors_by_fly = defaultdict(dict)
        contact_segs_by_leg = defaultdict(list)
        for seg in bodysegs_with_ground_contact:
            if seg.is_leg():
                contact_segs_by_leg[seg.pos].append(seg)
        for leg in fly.get_legs_order():
            segs = contact_segs_by_leg.get(leg)
            if not segs:
                continue
            subtree_root = _sort_legsegs_prox2dist(segs)[0]
            sensor = ContactSensorSpec(
                name=f"ground_contact_{leg}_leg",
                subtree_body=fly.bodyseg_to_specbody[subtree_root].full_identifier,
                geom2=self.ground_geom.full_identifier,
            )
            self._spec.contact_sensors.append(sensor)
            self.legpos_to_groundcontactsensors_by_fly[fly.name][leg] = sensor


class HeightfieldTerrainWorld(FlatGroundWorld):
    """Flat-ground world whose floor is a heightfield z = h(x, y).

    The reference v2 repo ships only flat/tethered worlds (complex terrain
    moved to flygym-gymnasium, SURVEY.md §0); this implements the
    NeuroMechFly rugged-terrain concept (BASELINE.json config 3) as a
    static height grid sampled bilinearly inside the step, with contact
    normals from the cell gradient.

    Args:
        name: World name.
        heights: (nrow, ncol) height grid in mm (row = y, col = x).
        xy0: World (x, y) of grid cell [0, 0].
        cell: (dx, dy) grid spacing in mm.
    """

    def __init__(
        self,
        name: str = "heightfield_world",
        *,
        heights: "np.ndarray" = None,
        xy0: tuple[float, float] = (-50.0, -50.0),
        cell: tuple[float, float] = (1.0, 1.0),
        half_size: float = 1000.0,
    ) -> None:
        import numpy as np

        super().__init__(name=name, half_size=half_size)
        if heights is None:
            heights = np.zeros((2, 2), np.float32)
        self._spec.hfield = {
            "data": np.asarray(heights, np.float32),
            "xy0": tuple(xy0),
            "cell": tuple(cell),
        }


class BlocksTerrainWorld(HeightfieldTerrainWorld):
    """Checkerboard of raised blocks (the NeuroMechFly "blocks" terrain).

    Args:
        block_size: Block edge length in mm.
        height_range: (lo, hi) random block heights in mm.
        extent: Terrain half-extent in mm.
        resolution: Grid cells per mm (edges are one cell wide → steep but
            finite slopes, the shape-static analog of beveled block edges).
        rng_seed: Seed for the block height pattern.
    """

    def __init__(
        self,
        name: str = "blocks_terrain_world",
        *,
        block_size: float = 1.3,
        height_range: tuple[float, float] = (0.2, 0.4),
        extent: float = 40.0,
        resolution: float = 4.0,
        rng_seed: int = 0,
    ) -> None:
        import numpy as np

        rng = np.random.default_rng(rng_seed)
        n = int(2 * extent * resolution)
        xs = (np.arange(n) / resolution) - extent
        bx = np.floor(xs / block_size).astype(int)
        n_blocks = bx.max() - bx.min() + 1
        block_h = rng.uniform(*height_range, size=(n_blocks, n_blocks))
        # Alternate raised blocks in a checkerboard, like NeuroMechFly.
        ii, jj = np.meshgrid(np.arange(n_blocks), np.arange(n_blocks), indexing="ij")
        block_h = np.where((ii + jj) % 2 == 0, block_h, 0.0)
        heights = block_h[np.ix_(bx - bx.min(), bx - bx.min())].astype(np.float32)
        super().__init__(
            name=name,
            heights=heights,
            xy0=(-extent, -extent),
            cell=(1.0 / resolution, 1.0 / resolution),
        )


class GappedTerrainWorld(HeightfieldTerrainWorld):
    """Parallel gaps across the walking direction (NeuroMechFly "gapped").

    Args:
        gap_width: Gap width in mm.
        block_width: Width of the solid ground strips in mm.
        gap_depth: Depth of the gaps in mm.
        extent: Terrain half-extent in mm.
        resolution: Grid cells per mm.
    """

    def __init__(
        self,
        name: str = "gapped_terrain_world",
        *,
        gap_width: float = 0.4,
        block_width: float = 1.0,
        gap_depth: float = 2.0,
        extent: float = 40.0,
        resolution: float = 8.0,
    ) -> None:
        import numpy as np

        n = int(2 * extent * resolution)
        xs = (np.arange(n) / resolution) - extent
        period = gap_width + block_width
        in_gap = (xs % period) < gap_width
        profile = np.where(in_gap, -gap_depth, 0.0).astype(np.float32)
        heights = np.broadcast_to(profile[None, :], (n, n)).copy()
        super().__init__(
            name=name,
            heights=heights,
            xy0=(-extent, -extent),
            cell=(1.0 / resolution, 1.0 / resolution),
        )


class TetheredWorld(BaseWorld):
    """World where the fly body is fixed in space; appendages move.

    Useful for motor control experiments without locomotion
    (``world.py:334-366``).

    Args:
        weld: ``"hard"`` (default) removes the root DoFs entirely — the
            body is exactly rigid in space (fastest, and what most motor-
            control analyses assume). ``"soft"`` reproduces the reference's
            equality-weld semantics: the root keeps its free joint and is
            pinned by a soft 6-DoF constraint at the reference's
            (solref, solimp), so constraint-force readouts and the µm-scale
            compliance at the tether match MuJoCo (golden-tested in
            tests/engine/test_weld_golden.py). Soft-weld models run on the
            engine step (not the mega-step kernel).
    """

    def __init__(self, name: str = "tethered_world", *, weld: str = "hard") -> None:
        if weld not in ("hard", "soft"):
            raise ValueError(f"weld must be 'hard' or 'soft', got {weld!r}")
        super().__init__(name=name)
        self.weld = weld

    def _attach_fly(self, fly, spawn_position: Vec3, spawn_rotation: Rotation3D):
        if self.weld == "hard":
            self._spec.attach(
                fly.spec,
                prefix=fly.name,
                spawn_pos=tuple(spawn_position),
                spawn_quat=tuple(spawn_rotation.values),
                free_joint_name=None,  # hard weld: no root DoFs
            )
            return None
        freejoint = self._spec.attach(
            fly.spec,
            prefix=fly.name,
            spawn_pos=tuple(spawn_position),
            spawn_quat=tuple(spawn_rotation.values),
            free_joint_name=fly.name,
        )
        root_body = f"{fly.name}/{fly.spec.bodies[0].name}"
        # Reference equality-weld parameters (world.py:356-360).
        self._spec.welds.append(
            (
                root_body,
                tuple(spawn_position),
                tuple(spawn_rotation.values),
                (2e-4, 1.0),
                (0.98, 0.99, 1e-5, 0.5, 3.0),
            )
        )
        return freejoint


def _dof_tuple(dof) -> list:
    """A joint DoF as (leg, parent link, child link, axis)."""
    return [dof.child.pos, dof.parent.link, dof.child.link, dof.axis.value]


def _fly_maps(world: BaseWorld, names: dict, fly_name: str, fly: Fly) -> dict:
    """The index maps of one fly, as ``flygym_tpu/simulation.py:88-150``
    resolves them from the compiler's name maps."""
    ns = fly_name
    act_ids = {}
    for ty in ActuatorType:
        specs = fly.jointdof_to_specactuator_by_type[ty]
        if specs:
            act_ids[ty.value] = [
                names["actuator_name2id"][a.full_identifier] for a in specs.values()
            ]
    adh_ids = []
    if fly.leg_to_adhesionactuator:
        adh_ids = [
            names["actuator_name2id"][fly.leg_to_adhesionactuator[leg].full_identifier]
            for leg in fly.get_legs_order()
        ]
    sensor_slots = []
    sensors = world.legpos_to_groundcontactsensors_by_fly
    if sensors and fly_name in sensors:
        sensor_slots = [
            names["sensor_name2slot"][sensors[fly_name][leg].full_identifier]
            for leg in fly.get_legs_order()
            if leg in sensors[fly_name]
        ]
    dofs = fly.get_jointdofs_order()
    return {
        "qpos_adrs": [names["hinge_qadr"][f"{ns}/{d.name}"] for d in dofs],
        "qvel_adrs": [names["hinge_vadr"][f"{ns}/{d.name}"] for d in dofs],
        "body_ids": [
            names["body_name2id"][f"{ns}/{seg.name}"] for seg in fly.get_bodysegs_order()
        ],
        "site_ids": [
            names["site_name2id"][f"{ns}/{joint.name}"] for joint in fly.get_sites_order()
        ],
        "act_ids": act_ids,
        "adh_ids": adh_ids,
        "sensor_slots": sensor_slots,
        "jointdofs": [_dof_tuple(d) for d in dofs],
        "actuated_dofs": {
            ty: [_dof_tuple(d) for d in fly.get_actuated_jointdofs_order(ty)]
            for ty in act_ids
        },
        "legs": list(fly.get_legs_order()),
    }


def _render_meta(spec: ModelSpec, names: dict, ngeom: int) -> dict:
    """What the renderer reads of a compiled world: every camera
    (``full_identifier``, ``mode``, ``pos``, ``quat``, ``fovy`` and its
    ``target`` as a body id, or None), the geom names by geom id and the
    body name map."""
    cameras = []
    for cam in spec.cameras:
        cameras.append({
            "name": cam.name,
            "full_identifier": cam.full_identifier,
            "mode": cam.mode,
            "pos": [float(x) for x in cam.pos],
            "quat": [float(x) for x in cam.quat],
            "fovy": float(cam.fovy),
            "target": None if cam.target is None else names["body_name2id"][cam.target],
        })
    id2geom = {v: k for k, v in names["geom_name2id"].items()}
    return {
        "cameras": cameras,
        "geom_names": [id2geom.get(g, "") for g in range(ngeom)],
        "body_name2id": {k: int(v) for k, v in names["body_name2id"].items()},
    }


def _sort_legsegs_prox2dist(segments: list[BodySegment]) -> list[BodySegment]:
    return sorted(segments, key=lambda seg: LEG_LINKS.index(seg.link))
