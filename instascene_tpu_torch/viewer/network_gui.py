"""Live viewer over TCP in the SIBR network-viewer protocol.

Port of instascene_tpu/viewer/network_gui.py. A non-blocking listener
(127.0.0.1:6009 by default) takes one viewer at a time. The viewer sends
length-prefixed JSON control messages: the resolution, the camera's
matrices in the reference's transposed storage with the sign flips on
columns 1-2, the field of view, the near and far planes, and whether
training may go on. Each is answered with the frame's raw RGB bytes, the
scene's source path and a metrics JSON. `tick` serves the viewer once per
training iteration, rendering through render() (K1 `full`).

What differs from the JAX package: a message is read until all its bytes
have arrived (`recv_exact`), where JAX reads it with one `recv`; the
camera's decoding is a function of its own (`camera_from_message`), with
its inverse (`camera_message`) for a client.
"""

from __future__ import annotations

import json
import socket
import struct
import traceback

import numpy as np
import torch

from ..cameras import MiniCam


def _send_json(conn, data) -> None:
    payload = json.dumps(data).encode("utf-8")
    conn.sendall(struct.pack("I", len(payload)))
    conn.sendall(payload)


def recv_exact(conn, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("the viewer closed the connection")
        buf += chunk
    return bytes(buf)


def camera_from_message(msg) -> MiniCam:
    """The viewer's camera: its matrices come in the reference's transposed
    storage with the sign flips on columns 1-2 (network_gui.py:91-95)."""
    wvt = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
    wvt[:, 1] *= -1
    wvt[:, 2] *= -1
    fpt = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
    fpt[:, 1] *= -1
    return MiniCam(msg["resolution_x"], msg["resolution_y"], msg["fov_y"],
                   msg["fov_x"], msg["z_near"], msg["z_far"], w2v=wvt.T,
                   full_proj=fpt.T)


def camera_message(cam, train: bool = True,
                   scaling_modifier: float = 1.0) -> dict:
    """A viewer's control message for `cam` (a Camera or MiniCam): the
    inverse of camera_from_message, bit for bit on the matrices."""
    wvt = np.asarray(cam.w2v, np.float32).T.copy()
    wvt[:, 1] *= -1
    wvt[:, 2] *= -1
    fpt = np.asarray(cam.full_proj, np.float32).T.copy()
    fpt[:, 1] *= -1
    return {"resolution_x": int(cam.width), "resolution_y": int(cam.height),
            "view_matrix": wvt.reshape(-1).tolist(),
            "view_projection_matrix": fpt.reshape(-1).tolist(),
            "fov_y": float(cam.fovy), "fov_x": float(cam.fovx),
            "z_near": float(cam.znear), "z_far": float(cam.zfar),
            "train": train, "keep_alive": True,
            "scaling_modifier": scaling_modifier, "render_mode": 0}


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn = None

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
            self.conn = None
        self.listener.close()

    def try_connect(self, render_items) -> None:
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
            _send_json(self.conn, render_items)
        except (BlockingIOError, OSError):
            pass

    def _read(self):
        n = int.from_bytes(recv_exact(self.conn, 4), "little")
        return json.loads(recv_exact(self.conn, n).decode("utf-8"))

    def receive(self):
        """(MiniCam, train, keep_alive, scaling_modifier, render_mode), or
        five Nones for a zero resolution or a malformed camera."""
        msg = self._read()
        if msg["resolution_x"] == 0 or msg["resolution_y"] == 0:
            return None, None, None, None, None
        try:
            return (camera_from_message(msg), bool(msg["train"]),
                    bool(msg["keep_alive"]), msg["scaling_modifier"],
                    msg["render_mode"])
        except Exception:
            traceback.print_exc()
            return None, None, None, None, None

    def send(self, image_bytes, verify: str, metrics) -> None:
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))
        _send_json(self.conn, metrics)

    @torch.no_grad()
    def tick(self, trainer, pipe, dataset) -> None:
        """One viewer service round inside the training loop (reference
        train.py:162-185): connect a waiting viewer, then answer its
        messages until it lets training go on or drops."""
        if self.conn is None:
            self.try_connect(getattr(dataset, "render_items", ["RGB"]))
        while self.conn is not None:
            try:
                cam, do_training, keep_alive, scale_mod, _mode = self.receive()
                img_bytes = None
                if cam is not None:
                    from ..render import render
                    pkg = render(cam, trainer.params, pipe, trainer.bg,
                                 scaling_modifier=scale_mod)
                    img = pkg["render"].cpu().numpy()
                    img_bytes = memoryview(
                        (np.clip(img, 0, 1) * 255).astype(np.uint8).tobytes())
                metrics = {"#": int(trainer.params.n_alive()),
                           "loss": trainer.ema.get("loss", 0.0)}
                self.send(img_bytes, dataset.source_path, metrics)
                if do_training:
                    break
            except Exception:
                self.conn = None
