"""Published architecture configurations the port runs at full width."""
