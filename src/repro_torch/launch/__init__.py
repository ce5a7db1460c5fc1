"""The launch layer: ``mesh`` (device meshes over a process group, the
production shapes without one, ``shard_map`` and the fake group of the
dry run), ``steps.build_cell`` (an (arch x shape x mesh) cell's step,
its abstract arguments and their layouts), ``op_stats`` (FLOPs, bytes
and collectives of a step run on the meta device), ``roofline`` (a lower
bound on a cell's step time on the H100, on one card or per device over
a mesh), ``dryrun`` (every cell run on the meta device, on one card or
over a production mesh: argument and peak bytes against one card), and
the command-line tools ``serve`` and ``train``."""
