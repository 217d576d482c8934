"""Local mapping stage: triangulation, fuse, local BA, culling."""
