"""The plain reference that decides `correct`: plain PyTorch (`frozen/`, a
frozen copy of the program's plain frame path and fly camera; `io.py`,
which replays the viewer's calls on that fly camera; `renderers/`, which
render a delivered frame from the benchmark's own scene and those poses).
It imports nothing of the program and takes nothing the program made."""
