"""Operation and byte counts behind ``mfu.*`` and ``conv_roofline.*``,
computed from a configuration's shapes and a cell's own inputs."""
