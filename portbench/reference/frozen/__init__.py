"""A frozen copy of flexlight_tpu_torch's plain frame path (the package's
state at commit 5c6cea5): the scene graph and its flatten, the scene
builders, the camera, the path-trace pass on the plain versions of the
kernels (fused_split / fused, kernel and sparse schemes), temporal
averaging, the denoise chain and FXAA, all in plain PyTorch.

It is a copy, not an import: later changes to the program do not reach
it, and it holds nothing of the CUDA launch layer (the kernel wrappers'
launch functions and the `_native` build are cut out; each kernel name is
bound to its plain version). The kernels of the program agree with these
plain versions bit for bit (chip_smoke.py), so the reference reproduces
the program's frames exactly. Modules keep their relative names, so the
copy's own imports resolve inside it."""
