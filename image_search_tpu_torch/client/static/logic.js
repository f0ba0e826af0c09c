// Pure client logic — the testable core of the UI behaviors the reference
// implements in compiled Rust (client/src/image_modal.rs:14-55 zoom/pan,
// image_card.rs:12-27 mark toggling, header.rs:13-20 submit guard,
// app.rs:26-56 search round-trip shapes).
//
// DISCIPLINE: this file is executed BOTH by the browser (via index.html)
// and by tests/test_client_logic.py, which translates this exact source
// through a strict JS-subset-to-Python translator (no JS runtime exists in
// the CI sandbox). Keep every function inside the subset: function/const/
// let/if/else/for-over-length/return, one ternary per expression, template
// literals, Math.min/max/abs, .push/.length/.trim, JSON.stringify, &&/||,
// ===/!==. The translator REJECTS anything else — a fancy construct here
// fails CI rather than silently losing coverage.

// scale clamp [0.5, 5.0] (image_modal.rs:14-34)
function clampScale(s) {
  return Math.min(5.0, Math.max(0.5, s));
}

// wheel-zoom about the cursor. cx/cy are the cursor offsets from the
// rendered image's center; the image point under the cursor stays fixed
// on screen. deltaY < 0 zooms in by 1.1x, else out by 1/1.1.
function wheelZoom(zoom, panX, panY, deltaY, cx, cy) {
  const factor = deltaY < 0 ? 1.1 : 1 / 1.1;
  const next = clampScale(zoom * factor);
  const applied = next / zoom;
  return {
    zoom: next,
    panX: panX - cx * (applied - 1),
    panY: panY - cy * (applied - 1),
  };
}

// mouse-drag panning step (image_modal.rs:36-55)
function panMove(panX, panY, lastX, lastY, clientX, clientY) {
  return {
    panX: panX + clientX - lastX,
    panY: panY + clientY - lastY,
    lastX: clientX,
    lastY: clientY,
  };
}

// CSS transform string applied to the modal image
function transformOf(zoom, panX, panY) {
  return `translate(${panX}px, ${panY}px) scale(${zoom})`;
}

// mark-checkbox toggling: marks persist across search rounds until
// un-checked (the reference's marked_images signal is never cleared,
// app.rs:24); returns a NEW list, first-marked order preserved.
function toggleMark(marked, path, checked) {
  const out = [];
  for (let i = 0; i < marked.length; i++) {
    if (marked[i] !== path) {
      out.push(marked[i]);
    }
  }
  if (checked) {
    out.push(path);
  }
  return out;
}

// Enter submits only when the query is non-empty (header.rs:13-20)
function shouldSearch(key, q) {
  return key === "Enter" && q.trim() !== "";
}

// POST /search body (SearchParams wire shape, data/src/lib.rs:4-9)
function searchBody(q, marked) {
  return JSON.stringify({ q: q, referenced_images: marked });
}

// SearchResponse -> result list; a missing images field renders empty
function resultsOf(data) {
  return data.images || [];
}

// status line after a scan round-trip
function scanStatusText(stats) {
  if (stats) {
    return `scan done: ${stats.embedded} new, ${stats.skipped_existing} known, ${stats.decode_failures} failed (${stats.seconds}s)`;
  }
  return "scan done";
}

// whether a modal backdrop click should close (click-outside,
// image_modal.rs:68); targetIsBackdrop is (e.target === modal)
function shouldCloseModal(targetIsBackdrop, key) {
  return targetIsBackdrop || key === "Escape";
}

// POST /remove body (server extension endpoint; reference cannot delete)
function removeBody(marked) {
  return JSON.stringify({ images: marked });
}

// results list after deleting `removed` paths (caller resets marks)
function afterRemoval(results, removed) {
  const out = [];
  for (let i = 0; i < results.length; i++) {
    const r = results[i];
    let keep = true;
    for (let j = 0; j < removed.length; j++) {
      if (r.image_path === removed[j]) {
        keep = false;
      }
    }
    if (keep) {
      out.push(r);
    }
  }
  return out;
}

// only marks VISIBLE in the current results may be deleted — invisible
// feedback marks from earlier rounds must never be silently destroyed
function visibleMarked(marked, results) {
  const out = [];
  for (let i = 0; i < marked.length; i++) {
    for (let j = 0; j < results.length; j++) {
      const r = results[j];
      if (r.image_path === marked[i]) {
        out.push(marked[i]);
      }
    }
  }
  return out;
}

// duplicates view after deletion: drop removed paths; a group shrinking
// below 2 members is no longer a duplicate group
function groupsAfterRemoval(groups, removed) {
  const out = [];
  for (let i = 0; i < groups.length; i++) {
    const g = groups[i];
    const kept = [];
    for (let j = 0; j < g.length; j++) {
      let hit = false;
      for (let k = 0; k < removed.length; k++) {
        if (g[j] === removed[k]) {
          hit = true;
        }
      }
      if (hit === false) {
        kept.push(g[j]);
      }
    }
    if (kept.length > 1) {
      out.push(kept);
    }
  }
  return out;
}

function removedStatusText(resp) {
  if (resp) {
    return `removed ${resp.removed} images`;
  }
  return "removed";
}

// GET /duplicates response -> groups; missing field renders empty
function duplicateGroupsOf(data) {
  return data.groups || [];
}

function dupStatusText(groups) {
  return `${groups.length} duplicate groups`;
}

// dropped/selected FileList -> the file to query with, or null. MIME
// filtering is left to the server (it answers 400 for undecodable bytes):
// drag sources often omit types, and rejecting here would hide the error.
function pickedQueryFile(files) {
  if (files) {
    if (files.length > 0) {
      return files[0];
    }
  }
  return null;
}

// POST /search_image URL: marked results ride as repeatable ?ref= params
// (the body is the raw image bytes, so the feedback selections cannot go
// in a JSON body like searchBody's referenced_images)
function imageSearchUrl(marked) {
  const parts = [];
  for (let i = 0; i < marked.length; i++) {
    parts.push("ref=" + encodeURIComponent(marked[i]));
  }
  if (parts.length > 0) {
    return "/search_image?" + parts.join("&");
  }
  return "/search_image";
}

/* EXPORT (ignored by the test translator) */
if (typeof window !== "undefined") {
  window.ISXLogic = {
    clampScale, wheelZoom, panMove, transformOf, toggleMark,
    shouldSearch, searchBody, resultsOf, scanStatusText, shouldCloseModal,
    removeBody, afterRemoval, removedStatusText, duplicateGroupsOf,
    dupStatusText, visibleMarked, groupsAfterRemoval, pickedQueryFile,
    imageSearchUrl,
  };
}
