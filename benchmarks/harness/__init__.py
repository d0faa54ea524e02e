"""The benchmark's harness: the run, its clock, its trace and its inputs."""
