"""The camera pose of every render call, worked out again from the calls
the viewer made on the engine's fly camera.

The harness records each call from outside on the program's WebIo, with
the time it passed (`io_log`: ("key_down" | "key_up", code, now_ms),
("update", now_ms), ("mouse_move", dx, dy)), and for each render call how
many of those calls came before it (`marks`). The frozen WebIo replays
them on the reference scene's own camera, from the scene's start pose.
"""

from __future__ import annotations

from .frozen.interaction import WebIo


def pose_of(camera) -> tuple:
    return (float(camera.x), float(camera.y), float(camera.z), float(camera.fx),
            float(camera.fy))


def poses(camera, io_log: list, marks: list, width: int, height: int) -> list[tuple]:
    """The pose at each render call: the replay of io_log[:marks[i]]."""
    first = next((e[-1] for e in io_log if e[0] != "mouse_move"), 0.0)
    io = WebIo(camera, first)
    out, done = [], 0
    for mark in marks:
        for entry in io_log[done:mark]:
            kind = entry[0]
            if kind == "update":
                io.update(entry[1])
            elif kind == "mouse_move":
                io.mouse_move(entry[1], entry[2], width, height)
            else:
                getattr(io, kind)(entry[1], entry[2])
        done = mark
        out.append(pose_of(camera))
    return out
