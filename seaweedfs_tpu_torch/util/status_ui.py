"""Shared HTML scaffolding for the status UI pages
(server/master_ui + volume_server_ui templates role)."""

from __future__ import annotations

_STYLE = (
    "body{font-family:sans-serif;margin:2em}"
    "table{border-collapse:collapse}td,th{border:1px solid #999;"
    "padding:4px 10px}"
)


def status_page(
    title: str,
    heading: str,
    intro_html: str,
    table_header_cells: list[str],
    table_rows_html: str,
    footer_links: list[str],
    section_heading: str | None = None,
) -> str:
    header = "".join(f"<th>{c}</th>" for c in table_header_cells)
    links = " &middot; ".join(
        f"<a href='{href}'>{href}</a>" for href in footer_links
    )
    if section_heading is None:
        section_heading = "Topology" if "Master" in title else "Volumes"
    return (
        f"<!DOCTYPE html><html><head><title>{title}</title>"
        f"<style>{_STYLE}</style></head><body>"
        f"<h1>{heading}</h1><p>{intro_html}</p>"
        f"<h2>{section_heading}</h2>"
        f"<table><tr>{header}</tr>{table_rows_html}</table>"
        f"<p>{links}</p></body></html>"
    )
