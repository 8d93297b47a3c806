"""Distribution: the data-axis helpers of sharded serving."""
