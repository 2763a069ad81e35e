from .ops import page_unpack
from .ref import page_unpack_ref
from .staging import Page, layout_pages, pack_pages, staging_bytes, write_pages

__all__ = ["Page", "layout_pages", "pack_pages", "page_unpack",
           "page_unpack_ref", "staging_bytes", "write_pages"]
