"""Multi-device paths: process groups, frames-data-parallel and row-band rendering."""
