"""Traffic mixes (one ``.json`` a mix) and the generator they share."""
