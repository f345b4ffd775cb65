"""Launchers of the port and the layout they plan for: the training
launcher (``train``), the serving launcher (``serve``), the assigned
input shapes and FLOP counts (``shapes``), the production mesh's axes
(``mesh``) and the sharding rules over them (``sharding``)."""

#: what ``--dry-run`` and ``--multi-pod`` raise in both launchers
DRY_RUN_NOT_PORTED = (
    "--dry-run and --multi-pod lower the production step on a TPU mesh in "
    "the reference; their port, launch/dryrun.py over launch/sharding.py's "
    "specs, is not written yet (ROADMAP Queue A, item 8e)")
