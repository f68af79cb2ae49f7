"""Which block of a batch-carrying axis each rank holds."""
