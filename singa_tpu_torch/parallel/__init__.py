"""Multi-host pieces of the port (`singa_tpu/parallel/`).  Only the
hostfile parser is here, for `serve.fleet.EngineFleet.from_hostfile`;
meshes, partitioning, pipeline and elastic training are ROADMAP.md A9.
"""
