"""Copy of platinum_tpu/app/store.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

One difference: `Store.import_texture` decodes LDR images through
io/png.py (`read_png`), not Pillow, which the render path does without.

Application store: scene + UI state with a deferred-action queue.

Rebuild of the reference's `pt::Store` (store.hpp / store.cpp): the owner of
the open scene, the current selection, and a one-slot deferred node-action
queue. UI code (widgets there, the interactive preview session here) never
mutates the scene mid-frame — it latches a selection / remove / center-camera
request on the store, and `update()` applies everything between frames
(store.cpp:56-67), so a frame never observes a half-applied edit.

File dialogs become explicit paths (SURVEY §2.6: CLI-path idiom for the
macOS dialog glue); Metal device/queue plumbing has no TPU equivalent —
device arrays are produced at flatten time instead.
"""

from __future__ import annotations

import enum
from pathlib import Path

import numpy as np

from platinum_tpu_torch.core.scene import RemoveMode, Scene
from platinum_tpu_torch.core.texture import Texture, TextureFormat, scan_alpha


class NodeAction(enum.Enum):
    NONE = 0
    REMOVE = 1
    CENTER_CAMERA = 2


class Store:
    """Scene + selection + deferred actions (reference store.hpp:13-96)."""

    def __init__(self, scene: Scene | None = None):
        self.scene = scene or Scene()
        self._selected: int | None = None
        self._next_selected: int | None = None
        self._action = NodeAction.NONE
        self._action_node: int | None = None
        self._remove_mode = RemoveMode.RECURSIVE
        self.rendering = False

    # ------------------------------------------------------------------
    # Selection: latched, applied at update() (store.hpp:56 m_nextNodeId)
    # ------------------------------------------------------------------
    @property
    def selected_node(self) -> int | None:
        return self._selected

    def select_node(self, node_id: int | None):
        self._next_selected = node_id

    # ------------------------------------------------------------------
    # Deferred node actions (store.hpp:61-80)
    # ------------------------------------------------------------------
    def set_node_action(self, action: NodeAction, node_id: int):
        self._action = action
        self._action_node = node_id

    def clear_node_action(self):
        self._action = NodeAction.NONE
        self._action_node = None

    def get_node_action(self) -> tuple[NodeAction, int]:
        if self._action_node is None:
            return NodeAction.NONE, self.scene.ROOT
        return self._action, self._action_node

    def remove_node(self, node_id: int,
                    mode: RemoveMode = RemoveMode.RECURSIVE):
        """Queue a removal; applied at the next update()."""
        self._remove_mode = mode
        self.set_node_action(NodeAction.REMOVE, node_id)

    def update(self) -> tuple[NodeAction, int | None]:
        """Apply latched selection + queued action between frames
        (store.cpp:56-67). Returns the action that was applied (callers
        like the preview session handle CENTER_CAMERA themselves, exactly
        as the reference's viewport does).

        The action slot always clears, even when the scene op raises (a
        bad queued removal must not re-raise every frame); the selection
        clears unconditionally on a removal, matching store.cpp:60-62."""
        self._selected = self._next_selected
        applied = (self._action, self._action_node)
        try:
            if (self._action == NodeAction.REMOVE
                    and self._action_node is not None):
                self.scene.remove_node(self._action_node, self._remove_mode)
                self._selected = self._next_selected = None
                self._remove_mode = RemoveMode.RECURSIVE
        finally:
            self.clear_node_action()
        return applied

    # ------------------------------------------------------------------
    # File ops (store.cpp:17-44, dialogs -> explicit paths)
    # ------------------------------------------------------------------
    def open(self, path: str):
        from platinum_tpu_torch.io.sceneio import load_scene

        self.scene = load_scene(path)
        self._selected = self._next_selected = None
        self.clear_node_action()

    def save_as(self, path: str):
        from platinum_tpu_torch.io.sceneio import save_scene

        save_scene(self.scene, path)

    def import_gltf(self, path: str) -> list:
        """Load a .gltf/.glb into the open scene; returns created root
        node ids (loaders::gltf::GltfLoader equivalent)."""
        from platinum_tpu_torch.io.gltf import load_gltf

        return load_gltf(self.scene, path, parent=self._selected)

    def import_texture(self, path: str, hdr: bool | None = None) -> int:
        """Load an image file as a standalone Texture asset
        (loaders::texture::TextureLoader equivalent; hdr=None infers from
        the extension like the reference's dialog filters hdr,exr vs
        png,jpg)."""
        p = Path(path)
        if hdr is None:
            hdr = p.suffix.lower() in (".exr", ".hdr")
        if hdr:
            if p.suffix.lower() == ".exr":
                from platinum_tpu_torch.io.exr import read_exr

                data = np.asarray(read_exr(str(p)), np.float32)
            else:
                from platinum_tpu_torch.io.hdr import read_hdr

                data = read_hdr(str(p))
            tex = Texture(data=data, format=TextureFormat.HDR, name=p.stem)
        else:
            from platinum_tpu_torch.io.png import read_png

            arr = read_png(str(p))
            tex = Texture(data=arr, format=TextureFormat.SRGB_RGBA,
                          name=p.stem, has_alpha=scan_alpha(arr))
        return self.scene.add_asset(tex, name=p.stem)

    def create_primitive(self, name: str, mesh) -> int:
        """Add a mesh asset + node under the selection (store.cpp:46-54);
        returns the node id."""
        asset_id = self.scene.add_asset(mesh, name=name)
        node = self.scene.create_node(name, parent=self._selected)
        self.scene.set_mesh(node.id, asset_id)
        return node.id
