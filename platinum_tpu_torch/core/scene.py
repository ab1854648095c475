"""Copy of platinum_tpu/core/scene.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Scene graph + asset store (host-side).

Capability parity with the Metal reference's src/core/scene.{hpp,cpp}: a node
hierarchy (name, transform, visibility, optional mesh-with-material-slots,
optional camera) over a refcounted asset store holding Mesh / Material /
Texture assets. Node operations: create, remove (3 modes), move/reparent with
cycle protection, clone (deep for the subtree, assets shared + retained),
world-transform resolution, instance and camera collection, hierarchy
traversal. The EnTT ECS of the reference is an implementation detail; a plain
id→node dict is the idiomatic Python equivalent with the same API surface.

Persistence (JSON + binary sidecar, scene.cpp:536-627) lives in
the JAX package's `platinum_tpu.io.sceneio` (not copied).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from platinum_tpu_torch.core.camera import Camera
from platinum_tpu_torch.core.environment import Environment
from platinum_tpu_torch.core.material import Material
from platinum_tpu_torch.core.mesh import Mesh
from platinum_tpu_torch.core.texture import Texture
from platinum_tpu_torch.core.transform import Transform


class RemoveMode(enum.Enum):
    RECURSIVE = "recursive"        # remove node and its whole subtree
    MOVE_TO_PARENT = "to_parent"   # children reparent to the removed node's parent
    MOVE_TO_ROOT = "to_root"       # children reparent to the root


@dataclass
class Node:
    id: int
    name: str = "node"
    parent: int | None = None
    children: list = field(default_factory=list)
    transform: Transform = field(default_factory=Transform)
    visible: bool = True
    mesh_id: int | None = None
    material_ids: list = field(default_factory=list)  # per mesh slot; None = default
    camera: Camera | None = None


@dataclass
class _Asset:
    id: int
    data: object  # Mesh | Material | Texture
    name: str
    refcount: int = 0
    retained: bool = False  # user pin: keep even at refcount 0


@dataclass
class Instance:
    node_id: int
    mesh_id: int
    mesh: Mesh
    material_ids: list
    transform: np.ndarray      # (4, 4) world
    normal_transform: np.ndarray  # (3, 3)
    visible: bool


class Scene:
    ROOT = 0

    def __init__(self):
        self._nodes: dict[int, Node] = {self.ROOT: Node(self.ROOT, name="root")}
        self._assets: dict[int, _Asset] = {}
        self._next_node_id = 1
        self._next_asset_id = 1
        self.environment = Environment()
        self.default_material = Material(name="default")

    # ------------------------------------------------------------------
    # Assets
    # ------------------------------------------------------------------

    def add_asset(self, data, name: str | None = None, retained: bool = False) -> int:
        aid = self._next_asset_id
        self._next_asset_id += 1
        name = name or getattr(data, "name", f"asset_{aid}")
        self._assets[aid] = _Asset(aid, data, name, retained=retained)
        return aid

    def asset(self, asset_id: int):
        a = self._assets.get(asset_id)
        return a.data if a is not None else None

    def asset_name(self, asset_id: int) -> str | None:
        a = self._assets.get(asset_id)
        return a.name if a is not None else None

    def set_retained(self, asset_id: int, retained: bool):
        a = self._assets[asset_id]
        a.retained = retained
        if not retained and a.refcount <= 0:
            self._remove_asset(asset_id)

    def retain_asset(self, asset_id: int | None):
        if asset_id is not None and asset_id in self._assets:
            self._assets[asset_id].refcount += 1

    def release_asset(self, asset_id: int | None):
        if asset_id is None or asset_id not in self._assets:
            return
        a = self._assets[asset_id]
        a.refcount -= 1
        if a.refcount <= 0 and not a.retained:
            self._remove_asset(asset_id)

    def _remove_asset(self, asset_id: int):
        a = self._assets.pop(asset_id, None)
        if a is None:
            return
        # A material releases the textures it references
        if isinstance(a.data, Material):
            for tex_id in list(a.data.textures.values()):
                self.release_asset(tex_id)
        if (self.environment.texture_id == asset_id):
            self.environment.set_texture(None)

    def assets_of_type(self, cls) -> list:
        return [(a.id, a.data) for a in self._assets.values() if isinstance(a.data, cls)]

    def all_assets(self) -> list:
        return [(a.id, a.data, a.name, a.refcount, a.retained) for a in self._assets.values()]

    # ------------------------------------------------------------------
    # Nodes
    # ------------------------------------------------------------------

    def node(self, node_id: int) -> Node:
        return self._nodes[node_id]

    def __contains__(self, node_id: int) -> bool:
        return node_id in self._nodes

    def create_node(self, name: str = "node", parent: int | None = None) -> Node:
        parent = self.ROOT if parent is None else parent
        nid = self._next_node_id
        self._next_node_id += 1
        node = Node(nid, name=name, parent=parent)
        self._nodes[nid] = node
        self._nodes[parent].children.append(nid)
        return node

    def set_mesh(self, node_id: int, mesh_id: int | None):
        node = self._nodes[node_id]
        if node.mesh_id is not None:
            self.release_asset(node.mesh_id)
            for mid in node.material_ids:
                self.release_asset(mid)
        node.mesh_id = mesh_id
        node.material_ids = []
        if mesh_id is not None:
            self.retain_asset(mesh_id)
            mesh = self.asset(mesh_id)
            node.material_ids = [None] * mesh.num_material_slots

    def set_material(self, node_id: int, slot: int, material_id: int | None):
        node = self._nodes[node_id]
        old = node.material_ids[slot]
        if old is not None:
            self.release_asset(old)
        node.material_ids[slot] = material_id
        if material_id is not None:
            self.retain_asset(material_id)

    def remove_node(self, node_id: int, mode: RemoveMode = RemoveMode.RECURSIVE):
        if node_id == self.ROOT:
            raise ValueError("cannot remove the root node")
        node = self._nodes[node_id]
        parent = node.parent

        if mode == RemoveMode.RECURSIVE:
            for child in list(node.children):
                self.remove_node(child, RemoveMode.RECURSIVE)
        else:
            target = parent if mode == RemoveMode.MOVE_TO_PARENT else self.ROOT
            for child in list(node.children):
                self.move_node(child, target)

        self._nodes[parent].children.remove(node_id)
        if node.mesh_id is not None:
            self.release_asset(node.mesh_id)
            for mid in node.material_ids:
                self.release_asset(mid)
        del self._nodes[node_id]

    def move_node(self, node_id: int, new_parent: int):
        if node_id == self.ROOT:
            raise ValueError("cannot reparent the root node")
        # Reject cycles: new_parent must not be inside node's subtree
        cursor = new_parent
        while cursor is not None:
            if cursor == node_id:
                raise ValueError("cannot move a node into its own subtree")
            cursor = self._nodes[cursor].parent
        node = self._nodes[node_id]
        self._nodes[node.parent].children.remove(node_id)
        node.parent = new_parent
        self._nodes[new_parent].children.append(node_id)

    def clone_node(self, node_id: int, parent: int | None = None) -> Node:
        """Deep-clone a subtree; assets are shared (and re-retained)."""
        src = self._nodes[node_id]
        parent = src.parent if parent is None else parent
        dst = self.create_node(src.name, parent)
        dst.transform = src.transform.copy()
        dst.visible = src.visible
        dst.camera = src.camera
        if src.mesh_id is not None:
            dst.mesh_id = src.mesh_id
            self.retain_asset(src.mesh_id)
            dst.material_ids = list(src.material_ids)
            for mid in dst.material_ids:
                self.retain_asset(mid)
        for child in src.children:
            self.clone_node(child, dst.id)
        return dst

    def world_transform(self, node_id: int) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        cursor = node_id
        while cursor is not None:
            m = self._nodes[cursor].transform.matrix() @ m
            cursor = self._nodes[cursor].parent
        return m

    def traverse(self, visit, start: int | None = None):
        """DFS over the hierarchy; visit(node, world_matrix, visible). Return
        False from visit to skip a subtree."""

        def rec(nid, parent_m, parent_visible):
            node = self._nodes[nid]
            m = parent_m @ node.transform.matrix()
            visible = parent_visible and node.visible
            if visit(node, m, visible) is False:
                return
            for child in node.children:
                rec(child, m, visible)

        rec(self.ROOT if start is None else start, np.eye(4, dtype=np.float32), True)

    def get_instances(self, include_hidden: bool = False) -> list:
        out = []

        def visit(node, m, visible):
            if node.mesh_id is not None and (visible or include_hidden):
                mesh = self.asset(node.mesh_id)
                lin = m[:3, :3]
                try:
                    nmat = np.linalg.inv(lin).T.astype(np.float32)
                except np.linalg.LinAlgError:
                    nmat = np.linalg.pinv(lin).T.astype(np.float32)
                out.append(
                    Instance(node.id, node.mesh_id, mesh, list(node.material_ids),
                             m, nmat, visible)
                )

        self.traverse(visit)
        return out

    def get_cameras(self) -> list:
        """[(node_id, Camera, world_transform)] for every camera node."""
        out = []

        def visit(node, m, visible):
            if node.camera is not None:
                out.append((node.id, node.camera, m))

        self.traverse(visit)
        return out

    def resolve_material(self, material_id: int | None) -> Material:
        if material_id is None:
            return self.default_material
        mat = self.asset(material_id)
        return mat if mat is not None else self.default_material

    @property
    def node_count(self) -> int:
        return len(self._nodes)
