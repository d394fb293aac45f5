"""SPM operator core: pairing schedules, eligibility, operator, linear."""
