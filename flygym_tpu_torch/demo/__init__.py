"""The replay benchmark of the Spotlight walking clip."""
