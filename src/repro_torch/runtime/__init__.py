"""Training runtime of the port: fault tolerance (straggler detection and
the checkpoint-restart supervisor)."""
