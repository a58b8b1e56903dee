"""What every cell shares: name resolution, the closed loop, the trace
reading, the card's peaks and the result line."""
