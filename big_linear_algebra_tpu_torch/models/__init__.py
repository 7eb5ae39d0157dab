"""Model programs with the reference's ``init | train | run`` CLIs."""
