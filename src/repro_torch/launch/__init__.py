"""Launchers of the port and the layout they plan for: the training
launcher (``train``), the serving launcher (``serve``), the assigned
input shapes and FLOP counts (``shapes``), the production mesh's axes
(``mesh``), the sharding rules over them (``sharding``), the dry run of
the production step at H100 rates (``dryrun``), its roofline table
(``roofline``) and the analysis of a profiled step (``hlo``)."""
