"""The benchmark's plain reference: a path tracer in plain PyTorch that
decides whether the timed path's images are correct.

It is written from the semantics of the path-traced cells, not from the
program: it imports nothing of `pathtracer_tpu_torch`, nothing of the JAX
package and no kernel, and takes nothing the program made. From the
benchmark's inputs (the seed, the cell's parameters, a mesh's triangles) it
works out again the scene, the camera, the sampler, a hierarchy of its own
over a mesh, the light paths and the film, by brute force or by its own
walk, in float64 by default. The same code in bfloat16 is the control that
has to come out as not correct.

Modules: `lds` (the sampler), `scenes` (camera, the shirley sphere list,
the ganesha mesh and floor), `bvh` (the reference's own mesh hierarchy and
walk), `film` (the reconstruction filter), `pt` (the path tracer).
"""
