"""Place recognition (loop closing itself is not ported yet)."""
