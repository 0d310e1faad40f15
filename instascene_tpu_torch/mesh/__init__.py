"""TSDF mesh export: fusion, marching tetrahedra, extraction (port of
instascene_tpu/mesh)."""
