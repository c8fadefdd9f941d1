"""Host-side math helpers: tree topology, ordered sets, and 3D rotation
specifications.

Port of ``flygym_tpu/utils/math.py`` (numpy, as there). The composition
layer uses them at model-build time; the engine's tensor math lives in
:mod:`flygym_tpu_torch.engine.maths`.

Parity reference: flygym ``utils/math.py`` (Tree :30-105, orderedset :108-110,
Rotation3D :113-164).
"""

from collections import deque
from dataclasses import dataclass
from numbers import Number
from typing import Generic, Hashable, Iterator, Literal, Sequence, TypeVar

import numpy as np

__all__ = [
    "Vec2",
    "Vec3",
    "Vec4",
    "Vec5",
    "Vec6",
    "Vec7",
    "Tree",
    "orderedset",
    "Rotation3D",
]

# Lightweight shape-documenting aliases (kept as plain ndarray for zero deps).
Vec2 = np.ndarray
Vec3 = np.ndarray
Vec4 = np.ndarray
Vec5 = np.ndarray
Vec6 = np.ndarray
Vec7 = np.ndarray

T = TypeVar("T", bound=Hashable)


class Tree(Generic[T]):
    """A validated undirected tree over hashable nodes.

    Used to represent kinematic skeletons. Construction validates tree-ness:
    unique nodes, edges between existing nodes, no self-loops, no parallel
    edges, connected, and exactly ``n - 1`` edges (hence acyclic).

    Args:
        nodes: Unique node identifiers.
        edges: ``(parent, child)`` connections.

    Raises:
        ValueError: If the graph is not a valid tree.
    """

    def __init__(self, nodes: Sequence[T], edges: Sequence[tuple[T, T]]) -> None:
        node_set = set(nodes)
        if len(node_set) != len(nodes):
            raise ValueError("Tree contains duplicate nodes")

        seen_edges: set[frozenset] = set()
        adjacency: dict[T, list[T]] = {n: [] for n in nodes}
        for u, v in edges:
            if u == v:
                raise ValueError(f"Edge ({u}, {v}) is a self-loop")
            if u not in node_set or v not in node_set:
                raise ValueError(f"Edge ({u}, {v}) not in tree")
            key = frozenset((u, v))
            if key in seen_edges:
                raise ValueError("Tree contains parallel edges")
            seen_edges.add(key)
            adjacency[u].append(v)
            adjacency[v].append(u)

        self.graph = adjacency

        if nodes and not self._connected_acyclic(len(edges)):
            raise ValueError("Tree is invalid")

    def _connected_acyclic(self, n_edges: int) -> bool:
        if n_edges != len(self.graph) - 1:
            return False
        # BFS connectivity check from an arbitrary node.
        start = next(iter(self.graph))
        reached = {start}
        frontier = deque([start])
        while frontier:
            node = frontier.popleft()
            for nbr in self.graph[node]:
                if nbr not in reached:
                    reached.add(nbr)
                    frontier.append(nbr)
        return len(reached) == len(self.graph)

    def dfs_edges(self, root: T) -> Iterator[tuple[T, T]]:
        """Yield ``(parent, child)`` edges in depth-first preorder from ``root``.

        Children are visited in insertion order (the order edges were given),
        which makes iteration deterministic — a requirement for the canonical
        DoF ordering contract of the composition layer.
        """
        if root not in self.graph:
            raise ValueError(f"Root '{root}' not in tree")
        visited = {root}
        # Stack of (parent, child); children pushed reversed to pop in order.
        stack: list[tuple[T, T]] = [
            (root, child) for child in reversed(self.graph[root])
        ]
        while stack:
            parent, child = stack.pop()
            if child in visited:
                continue
            visited.add(child)
            yield parent, child
            stack.extend(
                (child, grandchild) for grandchild in reversed(self.graph[child])
            )


def orderedset(items: list) -> list:
    """Deduplicate a list while preserving first-occurrence order."""
    return list(dict.fromkeys(items))


_ROTATION_DIMS = {"quat": 4, "axisangle": 4, "xyaxes": 6, "zaxis": 3, "euler": 3}


@dataclass(frozen=True)
class Rotation3D:
    """A 3D rotation in one of the orientation formats accepted by the model
    description layer (same conventions as MuJoCo frame orientations):
    ``quat`` (w, x, y, z), ``axisangle``, ``xyaxes``, ``zaxis``, or ``euler``.
    """

    format: Literal["quat", "axisangle", "xyaxes", "zaxis", "euler"]
    values: Sequence[Number]

    def __post_init__(self):
        if self.format not in _ROTATION_DIMS:
            raise ValueError(
                f"Invalid rotation spec: format={self.format}, values={self.values}. "
                f"Format must be one of {list(_ROTATION_DIMS)} and values must be a "
                "sequence of numbers."
            )
        if not isinstance(self.values, Sequence) or not all(
            isinstance(v, Number) for v in self.values
        ):
            raise ValueError(
                f"Invalid rotation spec: format={self.format}, values={self.values}. "
                f"Format must be one of {list(_ROTATION_DIMS)} and values must be a "
                "sequence of numbers."
            )
        expected = _ROTATION_DIMS[self.format]
        if len(self.values) != expected:
            raise ValueError(
                f"Invalid rotation spec: format={self.format}, values={self.values}. "
                f"Format {self.format} should be {expected}-dimensional, "
                f"got {len(self.values)}."
            )

    def as_kwargs(self) -> dict:
        """Return ``{format: values}`` for splatting into element constructors."""
        return {self.format: self.values}

    def as_quat_wxyz(self) -> np.ndarray:
        """Convert to a unit quaternion in (w, x, y, z) order."""
        v = np.asarray(self.values, dtype=np.float64)
        if self.format == "quat":
            q = v
        elif self.format == "axisangle":
            axis, angle = v[:3], v[3]
            axis = axis / np.linalg.norm(axis)
            q = np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])
        elif self.format == "euler":
            # Intrinsic rotations applied in the compiler's eulerseq (XYZ).
            q = np.array([1.0, 0, 0, 0])
            for axis_idx, angle in enumerate(v):
                axis = np.zeros(3)
                axis[axis_idx] = 1.0
                r = np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])
                q = _quat_mul_np(q, r)
        elif self.format == "zaxis":
            z = v / np.linalg.norm(v)
            q = _quat_from_z_np(z)
        elif self.format == "xyaxes":
            x = v[:3] / np.linalg.norm(v[:3])
            y = v[3:] - np.dot(v[3:], x) * x
            y = y / np.linalg.norm(y)
            z = np.cross(x, y)
            q = _quat_from_mat_np(np.stack([x, y, z], axis=1))
        else:  # pragma: no cover - guarded by __post_init__
            raise ValueError(self.format)
        return q / np.linalg.norm(q)


def _quat_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def _quat_from_z_np(z: np.ndarray) -> np.ndarray:
    """Minimal rotation taking (0, 0, 1) to the given unit vector."""
    e_z = np.array([0.0, 0.0, 1.0])
    c = float(np.dot(e_z, z))
    if c > 1 - 1e-12:
        return np.array([1.0, 0, 0, 0])
    if c < -1 + 1e-12:
        return np.array([0.0, 1.0, 0, 0])  # 180 deg about x
    axis = np.cross(e_z, z)
    axis = axis / np.linalg.norm(axis)
    angle = np.arccos(c)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


def _quat_from_mat_np(m: np.ndarray) -> np.ndarray:
    """Rotation matrix (3x3, columns are frame axes) to quaternion (w, x, y, z)."""
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array(
            [
                0.25 * s,
                (m[2, 1] - m[1, 2]) / s,
                (m[0, 2] - m[2, 0]) / s,
                (m[1, 0] - m[0, 1]) / s,
            ]
        )
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 0.0)) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q
