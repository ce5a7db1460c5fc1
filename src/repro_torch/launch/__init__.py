"""The launch layer on one device: ``steps.build_cell`` (an (arch x
shape) cell's step and its abstract arguments), ``op_stats`` (FLOPs and
bytes of a step run on the meta device), ``roofline`` (a lower bound on a
cell's step time on the H100), ``dryrun`` (every cell run on the meta
device: argument and peak bytes against one card), and the command-line
drivers ``serve`` and ``train``.  The reference's ``mesh`` waits for a
port that lays a model over several devices."""
