"""Named-frame transform graph: the TF-tree analog (the JAX package's
``utils/frames.py``, numpy only, copied).

The reference broadcasts odom->base_link into a full URDF TF tree
(scene_flow_constructor.cpp:320-349 + robot_state_publisher,
detect_with_zed.launch:36-54) so any consumer can ask for any
frame-to-frame transform. The pipeline itself only needs the single
static base_link<-camera extrinsic it carries in
``types.StereoModel.base_from_camera``, but multi-sensor rigs (several
cameras, an IMU, a lidar) need the general graph. This module is that
graph: a host-side tree of named frames with static edges (URDF role)
plus dynamic edges updated per frame (the odom->base_link broadcast
role), and ``lookup(target, source)`` composing through the tree —
``lookupTransform`` semantics without the distributed buffer (in one
process the latest value IS the buffer).

Transforms are (4, 4) numpy arrays (fetch a device tensor to the host
first) with the same convention as the pipeline: the edge (parent, child,
T) stores X_parent = T @ X_child. Pure host-side bookkeeping — the
per-frame program keeps taking explicit matrices; this resolves WHICH
matrix, once per frame, on the host.

Example (the detect_with_zed rig)::

    g = FrameGraph()
    g.add_static("base_link", "camera", T_base_from_camera)
    g.add_static("base_link", "imu", T_base_from_imu)
    g.update("odom", "base_link", odom_pose)       # per frame
    T = g.lookup("odom", "camera")                 # odom <- camera
"""

from __future__ import annotations

import numpy as np


class FrameGraphError(KeyError):
    """Unknown frame or disconnected pair (the TransformException role —
    the reference skips the frame on lookup failure,
    moving_objects_tracker.cpp:60-64)."""


class FrameGraph:
    def __init__(self):
        # child -> (parent, T, static) with X_parent = T @ X_child.
        # Like TF, every frame has at most one parent (a tree, not a DAG).
        self._parent: dict[str, tuple[str, np.ndarray, bool]] = {}
        self._frames: set[str] = set()

    # -- construction ----------------------------------------------------
    def _add(self, parent: str, child: str, T, static: bool):
        T = np.asarray(T, np.float64)
        if T.shape != (4, 4):
            raise ValueError(f"transform must be (4, 4), got {T.shape}")
        if child in self._parent and self._parent[child][0] != parent:
            raise ValueError(
                f"frame {child!r} already has parent "
                f"{self._parent[child][0]!r} (TF is a tree)"
            )
        # Reject cycles: walking up from `parent` must not reach `child`.
        node = parent
        while node in self._parent:
            node = self._parent[node][0]
            if node == child:
                raise ValueError(
                    f"edge {parent!r}->{child!r} would close a cycle"
                )
        self._parent[child] = (parent, T, static)
        self._frames.update((parent, child))

    def add_static(self, parent: str, child: str, T) -> None:
        """URDF-role edge: fixed for the graph's lifetime."""
        self._add(parent, child, T, static=True)

    def update(self, parent: str, child: str, T) -> None:
        """Dynamic-broadcast edge (odom->base_link role): create or
        refresh. Refusing to overwrite static edges catches rig-definition
        bugs early."""
        if child in self._parent and self._parent[child][2]:
            raise ValueError(f"edge to {child!r} is static")
        self._add(parent, child, T, static=False)

    # -- queries ---------------------------------------------------------
    def frames(self) -> set[str]:
        return set(self._frames)

    def _chain_to_root(self, frame: str):
        """[(frame, T_parent_from_frame), ...] up to the tree root."""
        if frame not in self._frames:
            raise FrameGraphError(f"unknown frame {frame!r}")
        chain = []
        node = frame
        while node in self._parent:
            parent, T, _ = self._parent[node]
            chain.append((node, T))
            node = parent
        chain.append((node, None))  # root sentinel
        return chain

    def lookup(self, target: str, source: str) -> np.ndarray:
        """T with X_target = T @ X_source (lookupTransform(target, source)
        semantics). Raises FrameGraphError when the frames live in
        disconnected trees."""
        up_t = self._chain_to_root(target)
        up_s = self._chain_to_root(source)
        if up_t[-1][0] != up_s[-1][0]:
            raise FrameGraphError(
                f"frames {target!r} and {source!r} are not connected "
                f"(roots {up_t[-1][0]!r} vs {up_s[-1][0]!r})"
            )
        # Common-ancestor trim: drop the shared suffix above the LCA so
        # long chains do not accumulate error through the root.
        names_t = [n for n, _ in up_t]
        names_s = [n for n, _ in up_s]
        set_t = set(names_t)
        lca = next(n for n in names_s if n in set_t)
        # X_lca = prod(T) @ X_source for the source-side chain up to lca.
        T_lca_from_source = np.eye(4)
        for name, T in up_s:
            if name == lca:
                break
            T_lca_from_source = T @ T_lca_from_source
        T_lca_from_target = np.eye(4)
        for name, T in up_t:
            if name == lca:
                break
            T_lca_from_target = T @ T_lca_from_target
        return np.linalg.inv(T_lca_from_target) @ T_lca_from_source

    def transform_points(self, target: str, source: str,
                         points: np.ndarray) -> np.ndarray:
        """Transform (..., 3) points from ``source`` into ``target``."""
        T = self.lookup(target, source)
        p = np.asarray(points, np.float64)
        return p @ T[:3, :3].T + T[:3, 3]
