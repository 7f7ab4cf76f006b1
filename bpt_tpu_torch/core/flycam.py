"""Free-fly (WASD) camera — the reference realtime camera's analog (port
of bpt_tpu/core/flycam.py: numpy on the host, on the port's `Camera`).

The reference's realtime mode drives a quaternion free-fly camera from
SDL events (reference: src/core/camera.h:8-13 `CameraRT`, adapted from
hamelot.co.uk; src/core/renderpass.cpp:419-449 `updateCamera` maps
W/A/S/D keydowns to Move(FORWARD/LEFT/BACK/RIGHT) and mouse drags to
pitch/heading).  This environment has no SDL/GL window, so the analog is
HEADLESS-SCRIPTABLE: the same motion model consumed from a command
stream (characters or explicit calls), driving the progressive-
refinement frame loop in bpt_tpu_torch/realtime.py, which resets accumulation
whenever the camera moves (a rasterizer redraws every frame; a
progressive path tracer restarts refinement on motion).

Motion model replicated from CameraRT exactly:
  * Move(dir) accumulates `camera_position_delta += dir * camera_scale`
    with camera_scale = 0.5 (camera.h:36,104-119);
  * ChangePitch/ChangeHeading clamp per-call rates to +/-5 and
    accumulate angles (camera.h:121-...);
  * Update() rotates the view direction by the pitch quaternion (about
    direction x up) composed with the heading quaternion (about up),
    integrates the position delta, then DAMPS: heading *= .5,
    pitch *= .5, delta *= .8 (camera.h:46-74);
  * the render camera is lookAt(position, position + direction, up)
    (camera.h:71), identical to the offline camera model.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .camera import Camera

_SCALE = 0.5          # camera_scale, camera.h:36
_MAX_RATE = 5.0       # max_pitch_rate / max_heading_rate, camera.h:37-38
_ANGLE_DAMP = 0.5     # camera.h:66-67
_DELTA_DAMP = 0.8     # camera.h:68


def _normalize(v):
    return v / max(float(np.linalg.norm(v)), 1e-20)


def _rotate(axis, angle, v):
    """Rodrigues rotation of v about unit axis by angle (radians) — the
    quaternion rotate in camera.h:51-60 without a quaternion type."""
    axis = _normalize(axis)
    c, s = np.cos(angle), np.sin(angle)
    return (v * c + np.cross(axis, v) * s
            + axis * float(np.dot(axis, v)) * (1.0 - c))


@dataclasses.dataclass
class FlyCamera:
    """Stateful free-fly camera; mutate with move()/pitch()/heading(),
    advance one frame with update(), read the render camera with
    camera(width, height)."""

    position: np.ndarray
    direction: np.ndarray
    up: np.ndarray
    fov: float
    _delta: np.ndarray = None
    _pitch: float = 0.0
    _heading: float = 0.0

    @staticmethod
    def from_lookat(o, at, up, fov) -> "FlyCamera":
        o = np.asarray(o, np.float64)
        at = np.asarray(at, np.float64)
        up = _normalize(np.asarray(up, np.float64))
        return FlyCamera(position=o, direction=_normalize(at - o), up=up,
                         fov=float(fov), _delta=np.zeros(3))

    # --- event layer (renderpass.cpp:419-449) -------------------------
    def move(self, d: str):
        """d in {'w','a','s','d','up','down'} — the SDL keydown map."""
        dirn, up = self.direction, self.up
        step = {
            "w": dirn, "s": -dirn,
            "a": -np.cross(dirn, up), "d": np.cross(dirn, up),
            "up": up, "down": -up,
        }[d]
        self._delta = self._delta + step * _SCALE

    def pitch(self, degrees: float):
        self._pitch += float(np.clip(degrees, -_MAX_RATE, _MAX_RATE))

    def heading(self, degrees: float):
        self._heading += float(np.clip(degrees, -_MAX_RATE, _MAX_RATE))

    # --- per-frame integration (camera.h:46-74) -----------------------
    def update(self) -> bool:
        """Advance one frame; returns True when the pose changed (the
        frame loop resets progressive accumulation on motion).

        Rotation order matches the reference exactly: the composed
        quaternion is pitch_quat * heading_quat (camera.h:57), i.e. the
        HEADING rotation applies first, then the pitch — with the pitch
        axis cross(direction, up) computed from the PRE-rotation
        direction (camera.h:51)."""
        moved = (abs(self._pitch) > 1e-9 or abs(self._heading) > 1e-9
                 or float(np.linalg.norm(self._delta)) > 1e-9)
        d = self.direction
        pitch_axis = np.cross(d, self.up)
        if abs(self._heading) > 1e-9:
            d = _rotate(self.up, np.radians(self._heading), d)
        if abs(self._pitch) > 1e-9:
            d = _rotate(pitch_axis, np.radians(self._pitch), d)
        self.direction = _normalize(d)
        self.position = self.position + self._delta
        self._heading *= _ANGLE_DAMP
        self._pitch *= _ANGLE_DAMP
        self._delta = self._delta * _DELTA_DAMP
        return moved

    def camera(self, width: int, height: int) -> Camera:
        at = self.position + self.direction  # camera.h:64
        return Camera.make(o=tuple(self.position), at=tuple(at),
                           up=tuple(self.up), fov=self.fov,
                           width=width, height=height)


def parse_commands(s: str):
    """Tiny command language for headless scripting of the event layer:
    'w','a','s','d' = one keydown; 'P+3.5;' / 'P-2;' = pitch degrees;
    'H+10;' = heading; '.' = end-of-frame (one Update()).  Example:
    'ww.P+5..a.' = two forward keys, frame, pitch, frame, frame, left,
    frame."""
    i = 0
    while i < len(s):
        c = s[i]
        if c in "wasd.":
            yield (c, 0.0)
            i += 1
        elif c in "PH":
            j = s.index(";", i)
            yield (c, float(s[i + 1:j]))
            i = j + 1
        elif c.isspace():
            i += 1
        else:
            raise ValueError(f"bad fly command {c!r} at {i}")
