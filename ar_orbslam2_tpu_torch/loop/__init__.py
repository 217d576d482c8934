"""Place recognition, loop closing and the loop-recall study."""
